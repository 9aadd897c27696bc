"""Edge-sharded global bundle adjustment (port of ``parallel/sharded_ba.py``).

The distributed form of ``ops.global_gn.gauss_newton_poses``: the edges and
their dense per-pixel fields are cut into one contiguous slice a shard
(``mesh.shard_edges``); the poses, pointmaps and confidences are copied to
every shard device (``mesh.replicate``).  Each shard gathers its edges'
correspondences once, then in every GN iteration assembles the (M+1, M+1,
7, 7) blocks, (M+1, 7) gradient and cost of its own edges; ray blocks come
from the edge-block kernel, one launch a shard an iteration.  The shards'
sums are added in shard order on the first shard's device and, across
processes, by one all-reduce each of H, g and cost, so every rank holds
the same bits; the dense solve and the retraction then run on every rank
alike.  This is the reference's ``SparseBlock`` reduction
(gn_kernels.cu:1199-1206) as a local scatter and a cross-device sum.

The solve is always dense, as the JAX package's sharded route is, whatever
``solver`` says and however many poses the graph has.  The loop is the JAX
``shard_map`` ``while_loop`` with its monotone-cost guard, and it stops
where that loop stops.  The route follows the mesh alone:

- every shard on one card and no process group (``one_program``): one
  launch of a device program a padded (poses, edges, shards) bucket, the
  single-device solve's machinery (``global_gn._Pieces``, ``_program``):
  the prologue gathers each shard's fields, the body sums the shards'
  systems in shard order, solves and advances, under a WHILE node;
- otherwise (a process group, shards on several cards, or the CPU): the
  iterations run eagerly and the loop's flag is read once an iteration
  (``gn_loop(..., early_exit=True)``).  Every rank holds the same bits
  after the all-reduce, so every rank reads the same flag, runs the same
  collectives and stops at the same iteration.  Where JAX's ``psum`` loop
  reads nothing, this reads one bool an iteration (under gloo the
  all-reduce already waits for the card each iteration).

A mesh changes the f32 summation order of the blocks against one device,
so the poses agree to a tolerance, not bit for bit; zero-weight padding
rows add exact zeros.
"""

from __future__ import annotations

import torch

from ..ops import global_gn
from ..ops.global_gn import (GlobalGNSettings, _scatter_dense, _slots, _solve_dense,
                             check_hg_impl, edge_blocks, gn_loop, precompute_edge_data)
from .mesh import Mesh, all_reduce_sum, check_same, replicate, shard_edges


def _local_blocks(Twc, K, img_hw, settings: GlobalGNSettings, mode: str, edge, M: int,
                  blocks=edge_blocks):
    """One shard's edges assembled into dense (Hbig, gbig) and their summed
    robust cost (``_local_blocks`` of the JAX package)."""
    H_e, g_e, c_e = blocks(Twc, edge, K, img_hw, settings, mode)
    io, jo = _slots(edge[0], edge[1], settings.pin, M)
    Hbig, gbig = _scatter_dense(H_e, g_e, io, jo, M)
    return Hbig, gbig, torch.sum(c_e)


def _shard_fields(mesh: Mesh, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K, img_hw,
                  settings: GlobalGNSettings, mode: str):
    """This process's shards: the edges cut (``shard_edges``) and each
    shard's correspondences gathered (they do not depend on the poses).
    Returns (each shard's (ii, jj, Xi, Xj, sq, ut, vt), each shard's K)."""
    ii_s, jj_s, idx_s, valid_s, Q_s = shard_edges(mesh, ii, jj, idx_ii2jj, valid_match, Q)
    Xs_r, Cs_r, K_r = replicate(mesh, Xs, Cs, K)
    edges = [(ii_s[s], jj_s[s]) + tuple(precompute_edge_data(
        Xs_r[s], Cs_r[s], ii_s[s], jj_s[s], idx_s[s], valid_s[s], Q_s[s], settings,
        mode, img_hw)) for s in range(mesh.local_size)]
    return edges, K_r


def _reduce(mesh: Mesh, Twc, edges, K_r, img_hw, settings: GlobalGNSettings, mode: str,
            blocks=edge_blocks):
    """The shards' (H, g, cost) at ``Twc`` summed in shard order on the first
    shard's device and over the ranks."""
    M = Twc.shape[0] - settings.pin
    dev0 = mesh.devices[0]
    (Tw,) = replicate(mesh, Twc)
    H = g = cost = None
    for s, edge in enumerate(edges):  # shard order, on the first shard's device
        Hs, gs, cs = (a.to(dev0) for a in _local_blocks(
            Tw[s], K_r[s], img_hw, settings, mode, edge, M, blocks))
        H, g, cost = ((Hs, gs, cs) if H is None else (H + Hs, g + gs, cost + cs))
    all_reduce_sum(mesh, H, g, cost)
    return H, g, cost


def _checked(mesh: Mesh, Twc, ii, jj, settings: GlobalGNSettings, mode: str):
    """Refuse what the card cannot run and check that the ranks agree on the
    problem's size (a collective: before any loop).  Returns ii, jj int64."""
    check_hg_impl(settings, mode, mesh.devices[0].type == "cuda")
    ii = torch.as_tensor(ii).long()
    jj = torch.as_tensor(jj).long()
    check_same(mesh, "the sharded solve's (edges, poses)", ii.shape[0], Twc.shape[0])
    return ii, jj


def one_program(mesh: Mesh) -> bool:
    """Whether a solve over ``mesh`` is one device program: every shard on
    one card, and no process group (whose collectives the program would
    have to hold)."""
    devs = mesh.distinct_devices()
    return not mesh.distributed and len(devs) == 1 and devs[0].type == "cuda"


class _ShardedPieces(global_gn._Pieces):
    """The sharded solve as a device program's pieces over the static
    ``inputs`` (``gauss_newton_poses``'s Twc ... K on the mesh's card): the
    prologue cuts and gathers every shard's fields into the program's
    memory; ``body`` sums the shards' systems in shard order (the blocks
    stand-ins during the warm-up), solves dense and advances, as
    ``gn_loop``'s step does."""

    def __init__(self, mesh: Mesh, inputs, img_hw, settings: GlobalGNSettings, mode: str):
        super().__init__("poses", inputs, img_hw, settings, mode, dense=True)
        self.mesh = mesh

    def _fields(self):
        _, Xs, Cs, ii, jj, idx, valid, Q, K = self.inputs
        return _shard_fields(self.mesh, Xs, Cs, ii, jj, idx, valid, Q, K, self.img_hw,
                             self.settings, self.mode)

    def body(self):
        edges, K_r = self.edge
        H, g, cost = _reduce(self.mesh, self.Twc, edges, K_r, self.img_hw, self.settings,
                             self.mode, self._edge_blocks)
        dx, ok = _solve_dense(H, g, self.M, self.settings.pcg_damping)
        self._advance(dx, ok, cost)


@torch.no_grad()
def normal_equations_sharded(mesh: Mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                             Q, K, img_hw, settings: GlobalGNSettings,
                             mode: str = "rays"):
    """The summed normal equations one GN iteration of
    ``gauss_newton_poses_sharded`` solves at ``Twc``: (Hbig (M+1, M+1, 7,
    7), gbig (M+1, 7), cost), on the first shard's device."""
    ii, jj = _checked(mesh, Twc, ii, jj, settings, mode)
    edges, K_r = _shard_fields(mesh, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K, img_hw,
                               settings, mode)
    return _reduce(mesh, Twc.to(mesh.devices[0]), edges, K_r, img_hw, settings, mode)


@torch.no_grad()
def gauss_newton_poses_sharded(mesh: Mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                               Q, K, img_hw, settings: GlobalGNSettings,
                               mode: str = "rays"):
    """Distributed GN over ``mesh``.  The arguments are
    ``gauss_newton_poses``'s, whole (every edge, on any device); each
    process takes its shards' slices, padded with zero-weight edges to a
    multiple of the mesh size.  Returns (Twc', iters, ok, diverged) on the
    first shard's device, the same bits on every rank; the step runs
    ``iters`` times (see the module docstring for the two routes; with
    ``max_iters`` 0 the eager loop, which runs none).  A program's build
    that fails raises."""
    ii, jj = _checked(mesh, Twc, ii, jj, settings, mode)
    dev0 = mesh.devices[0]
    if one_program(mesh) and settings.max_iters >= 1:
        # one program a (card, shards, mode, input shapes, image size,
        # settings), kept and counted with the single-device programs
        inputs = tuple(a.to(dev0) for a in (Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                                             Q, K))
        key = (dev0, "sharded", "dense", mode, tuple((a.shape, a.dtype) for a in inputs),
               tuple(img_hw), settings, mesh.size)
        return global_gn._program(
            key, lambda static: _ShardedPieces(mesh, static, img_hw, settings, mode), inputs)
    M = Twc.shape[0] - settings.pin
    edges, K_r = _shard_fields(mesh, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K, img_hw,
                               settings, mode)

    def step(Twc_, active):
        H, g, cost = _reduce(mesh, Twc_, edges, K_r, img_hw, settings, mode)
        dx, ok = _solve_dense(H, g, M, settings.pcg_damping)
        return dx, ok, cost

    return gn_loop(Twc.to(dev0), step, settings, early_exit=True)

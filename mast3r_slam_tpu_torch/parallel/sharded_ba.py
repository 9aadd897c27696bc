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
``solver`` says and however many poses the graph has.  The GN loop and
its monotone-cost guard are the single-device loop's (``global_gn.gn_loop``):
a fixed count of iterations frozen on the device, so every rank runs the
same collectives without reading the host.  A mesh changes the f32
summation order of the blocks against one device, so the poses agree to a
tolerance, not bit for bit; zero-weight padding rows add exact zeros.
"""

from __future__ import annotations

import torch

from ..ops.global_gn import (GlobalGNSettings, _scatter_dense, _slots, _solve_dense,
                             check_hg_impl, edge_blocks, gn_loop, precompute_edge_data)
from .mesh import Mesh, all_reduce_sum, check_same, replicate, shard_edges


def _local_blocks(Twc, K, img_hw, settings: GlobalGNSettings, mode: str, edge, M: int):
    """One shard's edges assembled into dense (Hbig, gbig) and their summed
    robust cost (``_local_blocks`` of the JAX package)."""
    H_e, g_e, c_e = edge_blocks(Twc, edge, K, img_hw, settings, mode)
    io, jo = _slots(edge[0], edge[1], settings.pin, M)
    Hbig, gbig = _scatter_dense(H_e, g_e, io, jo, M)
    return Hbig, gbig, torch.sum(c_e)


def _shard_problem(mesh: Mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K,
                   img_hw, settings: GlobalGNSettings, mode: str):
    """Check the ranks agree, cut the edges into this process's shards and
    gather each shard's correspondences (they do not depend on the poses).
    Returns ``reduce(Twc) -> (H, g, cost)``: the shards' blocks at ``Twc``
    summed in shard order on the first shard's device and over the ranks."""
    P = Twc.shape[0]
    M = P - settings.pin
    dev0 = mesh.devices[0]
    check_hg_impl(settings, mode, dev0.type == "cuda")
    ii = torch.as_tensor(ii).long()
    jj = torch.as_tensor(jj).long()
    check_same(mesh, "the sharded solve's (edges, poses)", ii.shape[0], P)
    ii_s, jj_s, idx_s, valid_s, Q_s = shard_edges(mesh, ii, jj, idx_ii2jj, valid_match, Q)
    Xs_r, Cs_r, K_r = replicate(mesh, Xs, Cs, K)
    edges = [(ii_s[s], jj_s[s]) + tuple(precompute_edge_data(
        Xs_r[s], Cs_r[s], ii_s[s], jj_s[s], idx_s[s], valid_s[s], Q_s[s], settings,
        mode, img_hw)) for s in range(mesh.local_size)]

    def reduce(Twc_):
        (Tw,) = replicate(mesh, Twc_)
        H = g = cost = None
        for s in range(mesh.local_size):  # shard order, on the first shard's device
            Hs, gs, cs = (a.to(dev0) for a in _local_blocks(
                Tw[s], K_r[s], img_hw, settings, mode, edges[s], M))
            H, g, cost = ((Hs, gs, cs) if H is None else (H + Hs, g + gs, cost + cs))
        all_reduce_sum(mesh, H, g, cost)
        return H, g, cost

    return reduce


@torch.no_grad()
def normal_equations_sharded(mesh: Mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                             Q, K, img_hw, settings: GlobalGNSettings,
                             mode: str = "rays"):
    """The summed normal equations one GN iteration of
    ``gauss_newton_poses_sharded`` solves at ``Twc``: (Hbig (M+1, M+1, 7,
    7), gbig (M+1, 7), cost), on the first shard's device."""
    return _shard_problem(mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K,
                          img_hw, settings, mode)(Twc.to(mesh.devices[0]))


@torch.no_grad()
def gauss_newton_poses_sharded(mesh: Mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                               Q, K, img_hw, settings: GlobalGNSettings,
                               mode: str = "rays"):
    """Distributed GN over ``mesh``.  The arguments are
    ``gauss_newton_poses``'s, whole (every edge, on any device); each
    process takes its shards' slices, padded with zero-weight edges to a
    multiple of the mesh size.  Returns (Twc', iters, ok, diverged) on the
    first shard's device, the same bits on every rank."""
    M = Twc.shape[0] - settings.pin
    reduce = _shard_problem(mesh, Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K,
                            img_hw, settings, mode)

    def step(Twc_, active):
        H, g, cost = reduce(Twc_)
        dx, ok = _solve_dense(H, g, M, settings.pcg_damping)
        return dx, ok, cost

    return gn_loop(Twc.to(mesh.devices[0]), step, settings)

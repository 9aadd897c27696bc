"""Keyframe factor graph with dense per-edge correspondence fields (port of
``slam/factor_graph.py``).

``add_factors`` runs symmetric two-view inference (one decoder call at
batch 2B) and two-way dense matching (one ``matching.match`` call over all
2B images: each image's matching is independent of the others), gates the
edges by their bidirectional match fraction (consecutive edges are always
kept; ``strict``, the default for relocalisation edges, keeps all or
none) and stores them.  The ``speed`` profile's fast paths (never taken by
a relocalisation call, which stays strict and bidirectional):

- ``local_opt.oneway_nonconsec``: a non-consecutive (loop-closure) pair
  runs one asymmetric decode and forward matching only; its backward
  half-row is stored zero-weight and its gate reads the forward fraction.
- ``local_opt.reuse_tracker_match``: a consecutive pair whose backward
  match the tracker captured stores that capture as its backward half and
  computes the forward half only.
- ``local_opt.speculative_gate``: every candidate is stored with its gate
  verdict computed and masked into its weights on the device, so the host
  does not wait for the match fractions; ``resolve_pending_verdicts``
  reads them later into ``edge_live``.

With ``local_opt.pixel_stride`` s > 1 an edge is matched from an s-strided
source grid (N/s^2 pixels) and its fields are scattered back to full shape,
zero-weight off the grid.

``solve`` expands the stored edges both ways and runs the global
Gauss-Newton, through the gathered-point cache when it applies, then writes
the solved poses back to the keyframe store (refused if a relocalisation
popped a keyframe meanwhile).

Both calls read the store through a snapshot they take themselves, or
through one snapshot the caller took (``snap``): the threaded backend
across processes takes it at a frame every rank agrees on, so that the
task reads the same store on every rank, and ``solve(snap=...)`` then
returns the write-back for the caller to install at another agreed frame
instead of installing it.  With ``local_opt.window_size`` below the
free poses (or under keyframe paging, whose ``keep_recent`` clamps the
window) it solves only the newest ``window`` poses: the edges that reach
the window, with their older endpoints as pinned context in a compact pose
array.  A windowed solve under paging, or with ``local_opt.edge_recycle``,
then retires the edges whose both ends lie before the window into a
freelist that later edges reuse, so the edge store stops growing.  A
keyframe store that pages is brought resident (``ensure_resident``) for
every keyframe a call reads, under the store's lock, right before the
snapshot.

The edge store is preallocated tensors on the device written in place.  A
solve pads its poses and edges to the JAX package's power-of-two buckets
(``local_opt.pose_bucket_floor``, ``edge_bucket_floor``), padded poses
without edges and padded edges zero-weight self-loops on a pinned pose, so
that a session meets few shapes: on the card each shape is a device
program of its own (``ops/global_gn.global_gn_graph``), as each is a
compiled program in the JAX package; the route (dense or PCG) follows the
padded pose count there too.  The model may live on another device than
the store (under ``engine.pipeline: 2`` the store is on the tracker's
card): the decode and the matching run on the model's device and their
outputs move to the store's.

With a ``mesh`` (``parallel/mesh.py``) the backend is sharded over its
edges, as the JAX package's five mesh branches do: the fast paths are off
(every pair symmetric and bidirectional, the gate read at once); the
symmetric decode batch is padded to a multiple of the mesh size with pairs
of keyframe 0 and each shard decodes and matches its slice on its own
device (a replica of the model on each device that holds none, built once);
the gathered-point cache is off; and every solve, windowed ones included,
is the edge-sharded dense solve (``parallel/sharded_ba.py``), whose edge
padding gives every shard at least one row (the JAX bucket floor of
mesh.size).  Across processes each rank decodes its slice and the results
are gathered on every rank, so every rank stores the same edges.
"""

from __future__ import annotations

import sys
import threading
from typing import List, Tuple

import numpy as np
import torch

from ..device import to_device, to_host
from ..geometry import constrain_points_to_ray
from ..ops import matching
from ..ops.global_gn import (GlobalGNSettings, gauss_newton_poses, gauss_newton_poses_cached,
                              routes_pcg)
from ..ops.matching import match_kwargs
from ..parallel.mesh import all_gather_rows, check_same, padded_rows
from ..parallel.sharded_ba import gauss_newton_poses_sharded
from .frame import Keyframes


def _bucket(n: int, lo: int = 1) -> int:
    """The least ``lo * 2**k`` that is >= n."""
    b = lo
    while b < n:
        b *= 2
    return b


def _store_edges(stores, rows, new) -> None:
    """Write new edges' fields into rows ``rows`` of the edge store, in place.
    ``stores`` and ``new`` are matching tuples of the six per-edge fields."""
    rows_t = to_device(rows, stores[0].device, torch.long)
    for dst, src in zip(stores, new):
        dst[rows_t] = src.to(dst)


def _refresh_gather(gf, gb, Xs, C_raw, K, eii, ejj, idx_f, idx_b, pos, img_hw,
                    mode: str) -> None:
    """Re-gather the cached [X | C_raw] rows of the edges ``pos``, in place.
    eii / ejj (S,) the source keyframes' slots in Xs / C_raw; idx_f / idx_b
    (S, N) match indices.
    Raw C is cached (normalised at solve time); calib mode caches
    ray-constrained X."""
    rows_i = torch.cat([Xs[eii], C_raw[eii]], dim=-1).float()
    rows_j = torch.cat([Xs[ejj], C_raw[ejj]], dim=-1).float()
    if mode == "calib":
        rows_i = torch.cat([constrain_points_to_ray(img_hw, rows_i[..., :3], K),
                            rows_i[..., 3:]], dim=-1)
        rows_j = torch.cat([constrain_points_to_ray(img_hw, rows_j[..., :3], K),
                            rows_j[..., 3:]], dim=-1)
    gf[pos] = torch.gather(rows_i, 1, idx_f.long()[..., None].expand(-1, -1, 4))
    gb[pos] = torch.gather(rows_j, 1, idx_b.long()[..., None].expand(-1, -1, 4))


def _expand_two_way(idx_f, idx_b, vf, vb, qf, qb, rows):
    """Stored edges ``rows`` (an index tensor, rows may repeat) both ways, in
    the layout [forward(rows) | backward(rows)]: (idx (2E, N), valid (2E, N,
    1), Q (2E, N, 1))."""
    return (torch.cat([idx_f[rows], idx_b[rows]]), torch.cat([vf[rows], vb[rows]]),
            torch.cat([qf[rows], qb[rows]]))


def _strided_rows(img_hw, stride: int, device) -> torch.Tensor:
    """Linear indices in the full grid of the s-strided source pixels: the
    matcher's warm start and where the strided fields are scattered."""
    H, W = img_hw
    r = (torch.arange(0, H, stride, dtype=torch.int32, device=device)[:, None] * W
         + torch.arange(0, W, stride, dtype=torch.int32, device=device)[None, :])
    return r.reshape(-1)


def _scatter_rows(rows, N: int, idx_s, valid_s, Q_s):
    """Strided matcher outputs -> full-shape edge fields; rows off the grid
    hold valid False and Q 0, zero weight in the solve."""
    B = idx_s.shape[0]
    r = rows.long()
    idx = idx_s.new_zeros((B, N))
    valid = valid_s.new_zeros((B, N, 1))
    Q = torch.zeros((B, N, 1), dtype=torch.float32, device=Q_s.device)
    idx[:, r] = idx_s
    valid[:, r] = valid_s
    Q[:, r] = Q_s.float()
    return idx, valid, Q


def _match_q(img_hw, stride: int, X1, X2, D1, D2, Q1, Q2, Q_conf: float, mk: dict):
    """Match images 1 -> 2 (batch B) from every pixel of 2, or from its
    s-strided grid, then aggregate Q = sqrt(Q1[idx] * Q2).  Returns
    full-shape (idx, valid, Q) and the match fraction of valid, confident
    source pixels."""
    B = X1.shape[0]
    N = img_hw[0] * img_hw[1]
    init = rows = None
    if stride > 1:
        rows = _strided_rows(img_hw, stride, X1.device)
        init = rows.expand(B, -1)
        X2, D2, Q2 = (a[:, ::stride, ::stride] for a in (X2, D2, Q2))
    idx, valid = matching.match(X1, X2, D1, D2, init, **mk)
    g = torch.gather(Q1.reshape(B, N, 1), 1, idx.long()[..., None])
    Q = torch.sqrt(g * Q2.reshape(B, -1, 1))
    frac = (valid & (Q > Q_conf)).float().mean(dim=(1, 2))
    if stride > 1:
        idx, valid, Q = _scatter_rows(rows, N, idx, valid, Q)
    return idx, valid, Q, frac


@torch.no_grad()
def _add_factors_compute(img_hw, res, Q_conf: float, mk: dict, stride: int = 1):
    """Two-way matching + Q aggregation for B pairs: the matcher runs once
    on the 2B images [ii | jj] (the JAX package unrolls it per pair for a
    TPU lowering reason; the indices are the same)."""
    (Xii, _, Dii, Qii), (Xji, _, Dji, Qji), (Xjj, _, Djj, Qjj), (Xij, _, Dij, Qij) = res
    B = Xii.shape[0]
    idx, valid, Q, frac = _match_q(
        img_hw, stride, torch.cat([Xii, Xjj]), torch.cat([Xji, Xij]),
        torch.cat([Dii, Djj]), torch.cat([Dji, Dij]), torch.cat([Qii, Qjj]),
        torch.cat([Qji, Qij]), Q_conf, mk)
    return dict(idx_i2j=idx[:B], idx_j2i=idx[B:], valid_j=valid[:B], valid_i=valid[B:],
                Qj=Q[:B], Qi=Q[B:], match_frac_j=frac[:B], match_frac_i=frac[B:])


@torch.no_grad()
def _add_factors_forward(img_hw, res, Q_conf: float, mk: dict, stride: int = 1):
    """Forward-only (i -> j) matching and Q aggregation for B pairs: the
    forward half of ``_add_factors_compute`` (the one-way and reuse paths)."""
    (Xii, _, Dii, Qii), (Xji, _, Dji, Qji) = res
    idx, valid, Q, frac = _match_q(img_hw, stride, Xii, Xji, Dii, Dji, Qii, Qji,
                                   Q_conf, mk)
    return dict(idx_i2j=idx, valid_j=valid, Qj=Q, match_frac_j=frac)


def _masked(keep, valid, Q):
    """An edge's weight fields with its on-device gate verdict applied: a
    rejected edge keeps valid False and Q 0, zero weight in the solve."""
    m = keep[:, None, None]
    return valid & m, Q * m.to(Q.dtype)


class FactorGraph:
    """Edges between keyframes and the global pose solve over them."""

    def __init__(self, model, cfg, keyframes: Keyframes, img_hw: Tuple[int, int],
                 K=None, edge_capacity: int = 1024, mesh=None):
        lcfg = cfg["local_opt"]
        self.model = model
        self.cfg = cfg
        self.lcfg = lcfg
        self.settings = GlobalGNSettings.from_config(cfg)
        self.keyframes = keyframes
        self.device = keyframes.device
        self.model_device = torch.device(getattr(model, "device", self.device))
        self.mesh = mesh
        self._replicas = {self.model_device: model}  # the model on each shard device
        self.img_hw = tuple(img_hw)
        self.K = (K if K is not None
                  else torch.eye(3, dtype=torch.float32, device=self.device))
        # free poses a solve may take; beyond it the solve takes a window
        self.window_size = int(float(lcfg.get("window_size", 0) or 0))
        self._recycle = bool(lcfg.get("edge_recycle", False))
        # backend matching on an s-strided source grid (1: every pixel)
        self._pstride = max(1, int(lcfg.get("pixel_stride", 1)))
        N = img_hw[0] * img_hw[1]
        self.N = N
        self.capacity = edge_capacity
        self.n_edges = 0
        dev = self.device
        self.ii = np.zeros((edge_capacity,), dtype=np.int32)
        self.jj = np.zeros((edge_capacity,), dtype=np.int32)
        self.idx_ii2jj = torch.zeros((edge_capacity, N), dtype=torch.int32, device=dev)
        self.idx_jj2ii = torch.zeros((edge_capacity, N), dtype=torch.int32, device=dev)
        self.valid_match_j = torch.zeros((edge_capacity, N, 1), dtype=torch.bool, device=dev)
        self.valid_match_i = torch.zeros((edge_capacity, N, 1), dtype=torch.bool, device=dev)
        self.Q_ii2jj = torch.zeros((edge_capacity, N, 1), dtype=torch.float32, device=dev)
        self.Q_jj2ii = torch.zeros((edge_capacity, N, 1), dtype=torch.float32, device=dev)
        # gathered-point cache: per-edge [X | C_raw] rows at the match
        # indices, re-gathered only when a source keyframe's pointmap
        # version moved; bounded by gather_cache_max_edges
        self._gcache_on = bool(lcfg.get("gather_cache", True))
        self._gcache_max = int(lcfg.get("gather_cache_max_edges", 256))
        self._gf = None  # (cache capacity, N, 4) f32
        self._gb = None
        self._gcache_cap = 0
        self._stamp_f = np.full((edge_capacity,), -1, dtype=np.int64)
        self._stamp_b = np.full((edge_capacity,), -1, dtype=np.int64)
        # speculative gate: each edge's verdict once read (until then True),
        # and the verdicts still on the device as (rows, keep, event); the
        # backend thread adds to them and the engine's end reads them
        self.edge_live = np.ones((edge_capacity,), dtype=bool)
        self._pending: List[tuple] = []
        self._verdict_lock = threading.Lock()
        # the last PCG-routed solve's `diverged` flag, read by the next solve
        self._health_pending = None
        self.n_recoveries = 0
        # rows of recycled edges, taken before the store grows
        self._free_edge_rows: List[int] = []
        self.n_edges_recycled = 0

    def _stores(self):
        return (self.idx_ii2jj, self.idx_jj2ii, self.valid_match_j,
                self.valid_match_i, self.Q_ii2jj, self.Q_jj2ii)

    # ------------------------------------------------------------------
    # add factors
    # ------------------------------------------------------------------

    def add_factors(self, ii: List[int], jj: List[int], min_match_frac: float,
                    is_reloc: bool = False, strict: bool = None,
                    captures=None, snap=None) -> bool:
        """Inference, matching, gate and store for the pairs (ii[b], jj[b]).
        An edge is kept when both match fractions reach ``min_match_frac``
        or it is consecutive (jj = ii + 1); with ``strict`` one rejected
        edge rejects them all.  ``is_reloc`` marks relocalisation edges (the
        new keyframe as ii, so never consecutive), which always take the
        bidirectional symmetric path; ``strict`` defaults to it.  Otherwise
        the ``speed`` switches pick each pair's path (see the module
        docstring); ``captures`` maps (i, j) to the tracker's (idx, valid, Q)
        of j's match against i.  ``snap``: read this snapshot of the store
        instead of taking one (see the module docstring).  Returns whether
        any edge was stored."""
        if strict is None:
            strict = is_reloc
        B = len(ii)
        if B == 0:
            return False
        kf = self.keyframes
        if snap is not None:
            snap = snap.with_resident(set(ii) | set(jj))
        else:
            with kf.lock:  # no eviction between the upload and the snapshot
                if kf.paging:
                    kf.ensure_resident(set(ii) | set(jj))
                snap = kf.snapshot()
        ii_arr = np.asarray(ii, dtype=np.int32)
        jj_arr = np.asarray(jj, dtype=np.int32)
        lcfg = self.lcfg
        fast = not is_reloc and self.mesh is None
        oneway = fast and bool(lcfg.get("oneway_nonconsec", False))
        reuse = fast and bool(lcfg.get("reuse_tracker_match", False)) and bool(captures)
        # the verdict must be read at once where strict needs all of them
        spec = fast and not strict and bool(lcfg.get("speculative_gate", False))
        if not (oneway or reuse):
            out = self._compute_symmetric(snap, ii_arr, jj_arr)
            if spec:
                return self._gate_store_symmetric_spec(out, ii_arr, jj_arr, min_match_frac)
            return self._gate_store_symmetric(out, ii_arr, jj_arr, min_match_frac, strict)

        consec = ii_arr == (jj_arr - 1)
        cap_mask = np.array([bool(c) and (int(a), int(b)) in captures
                             for a, b, c in zip(ii_arr, jj_arr, consec)]) \
            if reuse else np.zeros((B,), bool)
        one_mask = ~consec if oneway else np.zeros((B,), bool)
        sym_mask = ~(cap_mask | one_mask)
        # every group's device work is issued before any host read
        out_s = out_r = out_f = None
        if sym_mask.any():
            out_s = self._compute_symmetric(snap, ii_arr[sym_mask], jj_arr[sym_mask])
        if cap_mask.any():
            out_r = self._compute_oneway(snap, ii_arr[cap_mask], jj_arr[cap_mask])
        if one_mask.any():
            out_f = self._compute_oneway(snap, ii_arr[one_mask], jj_arr[one_mask])
        added = False
        if out_s is not None:
            if spec:
                added |= self._gate_store_symmetric_spec(
                    out_s, ii_arr[sym_mask], jj_arr[sym_mask], min_match_frac)
            else:
                added |= self._gate_store_symmetric(
                    out_s, ii_arr[sym_mask], jj_arr[sym_mask], min_match_frac, False)
        if out_r is not None:
            added |= self._store_reuse(out_r, ii_arr[cap_mask], jj_arr[cap_mask], captures)
        if out_f is not None:
            if spec:
                added |= self._gate_store_oneway_spec(
                    out_f, ii_arr[one_mask], jj_arr[one_mask], min_match_frac)
            else:
                added |= self._gate_store_oneway(
                    out_f, ii_arr[one_mask], jj_arr[one_mask], min_match_frac)
        return added

    def _pair_tokens(self, snap, si, sj, device):
        """(feat_i, pos_i, feat_j, pos_j) of the pairs at snapshot slots
        ``si`` / ``sj``, on ``device``."""
        si = to_device(si, snap.feat.device, torch.long)
        sj = to_device(sj, snap.feat.device, torch.long)
        return tuple(a.to(device) for a in (snap.feat[si], snap.pos[si],
                                            snap.feat[sj], snap.pos[sj]))

    def _on_store(self, out: dict) -> dict:
        return {k: v.to(self.device) for k, v in out.items()}

    def _compute_symmetric(self, snap, ii_arr, jj_arr):
        if self.mesh is not None:
            return self._compute_symmetric_sharded(snap, ii_arr, jj_arr)
        res = self.model.symmetric(*self._pair_tokens(
            snap, snap.slots(ii_arr), snap.slots(jj_arr), self.model_device))
        return self._on_store(_add_factors_compute(
            self.img_hw, res, float(self.lcfg["Q_conf"]), match_kwargs(self.cfg),
            self._pstride))

    def _replica(self, device):
        """The model on ``device``: the model itself on its own device, else
        a replica built at first use (``model.replica(device)``)."""
        if device not in self._replicas:
            if not hasattr(self.model, "replica"):
                raise TypeError(
                    f"a mesh shard on {device} needs the model there, and "
                    f"{type(self.model).__name__} has no replica(device)")
            self._replicas[device] = self.model.replica(device)
        return self._replicas[device]

    def _compute_symmetric_sharded(self, snap, ii_arr, jj_arr):
        """``_compute_symmetric`` over the mesh: B pairs padded with pairs of
        slot 0 to a multiple of the mesh size, each shard's contiguous slice
        decoded and matched on its device; the real pairs' outputs on the
        store's device (gathered from every rank across processes)."""
        mesh = self.mesh
        B = len(ii_arr)
        check_same(mesh, "the sharded decode's (pairs, keyframes)", B, snap.n)
        rows = padded_rows(mesh, B)
        per = rows // mesh.size
        si = np.zeros((rows,), np.int64)
        sj = np.zeros((rows,), np.int64)
        si[:B] = snap.slots(ii_arr)
        sj[:B] = snap.slots(jj_arr)
        Q_conf, mk = float(self.lcfg["Q_conf"]), match_kwargs(self.cfg)
        outs = []
        for s, d in enumerate(mesh.devices):
            r0 = (mesh.first_shard + s) * per
            res = self._replica(d).symmetric(*self._pair_tokens(
                snap, si[r0:r0 + per], sj[r0:r0 + per], d))
            out = _add_factors_compute(self.img_hw, res, Q_conf, mk, self._pstride)
            # one process: only the real pairs leave their shard
            keep = per if mesh.distributed else max(0, min(per, B - r0))
            outs.append({k: v[:keep].to(self.device) for k, v in out.items()})
        out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        if mesh.distributed:
            out = {k: all_gather_rows(mesh, v)[:B] for k, v in out.items()}
        return out

    def _compute_oneway(self, snap, ii_arr, jj_arr):
        """One asymmetric decode and forward matching a pair."""
        res = self.model.asymmetric(*self._pair_tokens(
            snap, snap.slots(ii_arr), snap.slots(jj_arr), self.model_device))
        return self._on_store(_add_factors_forward(
            self.img_hw, res, float(self.lcfg["Q_conf"]), match_kwargs(self.cfg),
            self._pstride))

    def _store(self, ii_arr, jj_arr, fields) -> np.ndarray:
        """Store new edges (ii, jj) with their six fields; returns the rows."""
        rows = self._take_edge_rows(len(ii_arr))
        self.ii[rows] = ii_arr
        self.jj[rows] = jj_arr
        _store_edges(self._stores(), rows, fields)
        # new edges have no cached gather rows yet
        self._stamp_f[rows] = -1
        self._stamp_b[rows] = -1
        with self._verdict_lock:
            self.edge_live[rows] = True
        return rows

    @staticmethod
    def _oneway_fields(idx_f, valid_f, Q_f):
        """A forward-only edge's fields: the backward half-row zero-weight."""
        return (idx_f, torch.zeros_like(idx_f), valid_f, torch.zeros_like(valid_f),
                Q_f, torch.zeros_like(Q_f))

    def _gate_store_symmetric(self, out, ii_arr, jj_arr, min_match_frac: float,
                              strict: bool) -> bool:
        # one host read of both directions' match fractions
        frac_j, frac_i = torch.stack(
            [out["match_frac_j"], out["match_frac_i"]]).cpu().numpy()
        consecutive = ii_arr == (jj_arr - 1)
        invalid = (~consecutive) & (np.minimum(frac_j, frac_i) < min_match_frac)
        if strict and invalid.any():
            return False
        kidx = np.nonzero(~invalid)[0]
        if kidx.size == 0:
            return False
        k = torch.as_tensor(kidx, device=self.device).long()
        self._store(ii_arr[kidx], jj_arr[kidx], tuple(
            out[key][k] for key in ("idx_i2j", "idx_j2i", "valid_j", "valid_i",
                                    "Qj", "Qi")))
        return True

    def _gate_store_oneway(self, out, ii_arr, jj_arr, min_match_frac: float) -> bool:
        """Forward-only edges, gated by the forward match fraction alone."""
        kidx = np.nonzero(out["match_frac_j"].cpu().numpy() >= min_match_frac)[0]
        if kidx.size == 0:
            return False
        k = torch.as_tensor(kidx, device=self.device).long()
        self._store(ii_arr[kidx], jj_arr[kidx], self._oneway_fields(
            out["idx_i2j"][k], out["valid_j"][k], out["Qj"][k]))
        return True

    def _store_reuse(self, out, ii_arr, jj_arr, captures) -> bool:
        """Consecutive edges whose backward half is the tracker's captured
        match; they are kept without a gate, so nothing is read."""
        caps = [captures[(int(a), int(b))] for a, b in zip(ii_arr, jj_arr)]
        self._store(ii_arr, jj_arr, (
            out["idx_i2j"], torch.stack([c[0] for c in caps]), out["valid_j"],
            torch.stack([c[1] for c in caps]), out["Qj"],
            torch.stack([c[2] for c in caps])))
        return True

    def _gate_store_symmetric_spec(self, out, ii_arr, jj_arr,
                                   min_match_frac: float) -> bool:
        """Store every candidate with its bidirectional verdict masked in on
        the device (solve-identical to storing the kept ones only); the
        verdicts are read later (``resolve_pending_verdicts``)."""
        consec = to_device(ii_arr == (jj_arr - 1), self.device)
        keep = consec | (torch.minimum(out["match_frac_j"], out["match_frac_i"])
                         >= min_match_frac)
        vj, qj = _masked(keep, out["valid_j"], out["Qj"])
        vi, qi = _masked(keep, out["valid_i"], out["Qi"])
        rows = self._store(ii_arr, jj_arr, (out["idx_i2j"], out["idx_j2i"], vj, vi, qj, qi))
        self._add_pending(rows, keep)
        return True

    def _gate_store_oneway_spec(self, out, ii_arr, jj_arr, min_match_frac: float) -> bool:
        """The speculative gate of forward-only candidates (forward fraction)."""
        keep = out["match_frac_j"] >= min_match_frac
        vj, qj = _masked(keep, out["valid_j"], out["Qj"])
        rows = self._store(ii_arr, jj_arr, self._oneway_fields(out["idx_i2j"], vj, qj))
        self._add_pending(rows, keep)
        return True

    def _add_pending(self, rows, keep):
        event = None
        if keep.is_cuda:  # the verdict is read on another thread's stream
            event = torch.cuda.Event()
            event.record()
        with self._verdict_lock:
            self._pending.append((rows, keep, event))

    def resolve_pending_verdicts(self):
        """Read the outstanding speculative verdicts (one host read) and mark
        rejected edges dead in ``edge_live``.  Dead edges stay zero-weight
        rows on the device, which the solve ignores either way."""
        with self._verdict_lock:
            pending, self._pending = self._pending, []
            if not pending:
                return
            for _, _, event in pending:
                if event is not None:
                    event.synchronize()
            keeps = torch.cat([k for _, k, _ in pending]).cpu().numpy()
            at = 0
            for rows, keep, _ in pending:
                self.edge_live[rows] = keeps[at:at + len(rows)]
                at += len(rows)

    @property
    def n_live_edges(self) -> int:
        """Edges that passed (or never needed) the gate: ``n_edges`` unless
        the speculative gate left dead rows."""
        self.resolve_pending_verdicts()
        with self._verdict_lock:
            return int(self.edge_live[: self.n_edges].sum())

    def _take_edge_rows(self, B: int) -> np.ndarray:
        """B edge rows: recycled rows first, then fresh rows off the end of
        the store, growing it if needed."""
        rows = self._free_edge_rows[:B]
        del self._free_edge_rows[:B]
        need = B - len(rows)
        if need:
            self._ensure_capacity(self.n_edges + need)
            rows.extend(range(self.n_edges, self.n_edges + need))
            self.n_edges += need
        return np.asarray(rows, dtype=np.int32)

    def _recycle_old_edges(self, s0: int):
        """Retire the edges whose both ends lie before the window's first
        pose ``s0``.  No windowed solve reads them again (the window only
        moves forward), so this changes no solve; their rows are zeroed on
        the device (zero weight, should a full solve see them), marked dead
        and queued for reuse."""
        self.resolve_pending_verdicts()
        E = self.n_edges
        if E == 0:
            return
        free = np.zeros((E,), bool)
        free[[r for r in self._free_edge_rows if r < E]] = True
        rows = np.nonzero((self.ii[:E] < s0) & (self.jj[:E] < s0) & ~free)[0]
        if rows.size == 0:
            return
        r = torch.as_tensor(rows, device=self.device).long()
        for a in (self.valid_match_j, self.valid_match_i, self.Q_ii2jj, self.Q_jj2ii):
            a[r] = 0
        self.ii[rows] = 0
        self.jj[rows] = 0
        self._stamp_f[rows] = -1
        self._stamp_b[rows] = -1
        with self._verdict_lock:
            self.edge_live[rows] = False
        self._free_edge_rows = sorted(self._free_edge_rows + rows.tolist())
        self.n_edges_recycled += int(rows.size)

    def seed_free_rows(self):
        """Queue the dead rows a recycle left (edge_live False, ii == jj == 0)
        for reuse: a checkpoint holds the rows but not the freelist."""
        E = self.n_edges
        with self._verdict_lock:
            dead = ~self.edge_live[:E] & (self.ii[:E] == 0) & (self.jj[:E] == 0)
        self._free_edge_rows = np.nonzero(dead)[0].tolist()

    def _ensure_capacity(self, needed: int):
        """Double the edge store (copying it) until ``needed`` rows fit."""
        if needed <= self.capacity:
            return
        new_cap = _bucket(needed, self.capacity)
        pad = new_cap - self.capacity

        def grow(a):
            return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

        (self.idx_ii2jj, self.idx_jj2ii, self.valid_match_j, self.valid_match_i,
         self.Q_ii2jj, self.Q_jj2ii) = (grow(a) for a in self._stores())
        self.ii = np.concatenate([self.ii, np.zeros(pad, np.int32)])
        self.jj = np.concatenate([self.jj, np.zeros(pad, np.int32)])
        self._stamp_f = np.concatenate([self._stamp_f, np.full(pad, -1, np.int64)])
        self._stamp_b = np.concatenate([self._stamp_b, np.full(pad, -1, np.int64)])
        with self._verdict_lock:
            self.edge_live = np.concatenate([self.edge_live, np.ones(pad, bool)])
        self.capacity = new_cap

    # ------------------------------------------------------------------
    # solve
    # ------------------------------------------------------------------

    def solve(self, mode: str = None, snap=None, ver=None):
        """Global GN over the keyframe poses (the first ``pin`` stay fixed),
        over all of them or over a window, then the pose write-back.  After
        a PCG-routed solve that raised the cost, this one runs dense, its
        window clamped to ``dense_max_poses`` as well.  Given ``snap`` (and
        the ``pm_version`` copy ``ver`` taken with it), the solve reads that
        snapshot and returns its write-back, the arguments of
        ``Keyframes.write_back_poses`` (None when there was nothing to
        solve), instead of installing it."""
        if mode is None:
            mode = "calib" if self.cfg["use_calib"] else "rays"
        kf = self.keyframes
        E = self.n_edges
        if E == 0 or (len(kf) if snap is None else snap.n) <= self.settings.pin:
            return None
        settings = self.settings
        window = self._effective_window()
        if self._consume_health():
            settings = settings._replace(solver="dense")
            window = min(window or 10 ** 9, settings.dense_max_poses)
        deferred = snap is not None
        if deferred:
            free = snap.n - settings.pin
            window = min(window or free, free)
            if kf.paging:
                refs, s0 = self._window_refs(snap.n, window)
                snap = snap.with_resident(list(refs) + list(range(s0, snap.n)))
        else:
            with kf.lock:  # no eviction between the uploads and the snapshot
                free = len(kf) - settings.pin
                window = min(window or free, free)
                self._prepare_residency(window)
                # versions before the snapshot: a fusion landing in between is
                # re-gathered next solve, never served stale
                ver = kf.pm_version.copy()
                snap = kf.snapshot()
        old = self.settings
        self.settings = settings
        try:
            write_back = self._solve_window(mode, snap, E, window, ver)
        finally:
            self.settings = old
        if deferred or write_back is None:
            return write_back
        kf.write_back_poses(*write_back)
        return None

    def _effective_window(self) -> int:
        """``window_size``, clamped under paging to ``keep_recent``: only the
        newest ``keep_recent`` keyframes are sure to be resident."""
        window = self.window_size
        if self.keyframes.paging:
            window = min(window or 10 ** 9, self.keyframes.keep_recent)
        return window

    def _window_refs(self, n_now: int, window: int):
        """(the keyframes the edges reaching the newest ``window`` of
        ``n_now`` poses touch, the window's first pose)."""
        E = self.n_edges
        s0 = n_now - window
        ii_e, jj_e = self.ii[:E], self.jj[:E]
        keep = (ii_e >= s0) | (jj_e >= s0)
        return np.unique(np.concatenate([ii_e[keep], jj_e[keep]])), s0

    def _prepare_residency(self, window: int):
        """Under paging, bring back every keyframe a solve of the newest
        ``window`` poses reads (the window and the older ends of its edges)
        and mark the older ones sticky, so that solve after solve does not
        evict and upload them again.  Caller holds the store's lock."""
        kf = self.keyframes
        if not kf.paging or self.n_edges == 0:
            return
        n_now = len(kf)
        refs, s0 = self._window_refs(n_now, window)
        kf.sticky = {int(r) for r in refs if r < s0}
        kf.ensure_resident([int(r) for r in refs] + list(range(s0, n_now)))

    def _solve_window(self, mode: str, snap, E: int, window: int, ver):
        """Solve the newest ``window`` poses (all the free ones when there is
        no window).  Poses before ``s0`` stay fixed; the edges with an end in
        the window are kept.  Without a window (``s0`` = ``pin``) the
        compact pose array is the keyframes [0, n), as the JAX package's
        ``_solve_full`` takes them; with one, it is [pinned context |
        window], the older ends of the kept edges entering as pinned poses
        (``_solve_windowed``).  Edges between two older poses would touch
        pinned poses only, so dropping them changes nothing.  Both are
        padded to the buckets (``_buckets``).  A solve that leaves free
        poses out then recycles the edges behind the window (under paging
        or ``edge_recycle``).  Returns the write-back
        (``Keyframes.write_back_poses``'s arguments), or None."""
        n_kf = snap.n
        s0 = n_kf - window
        ii_e, jj_e = self.ii[:E], self.jj[:E]
        keep = (ii_e >= s0) | (jj_e >= s0)
        kept = np.nonzero(keep)[0]
        if kept.size == 0:
            return None
        sel, remap, pin, Ppad, half = self._buckets(n_kf, s0, ii_e[kept], jj_e[kept])
        K_ = kept.size
        mii, mjj = remap[ii_e[kept]], remap[jj_e[kept]]
        # two-way layout [forward | backward], each padded with self-loops on
        # compact pose 0 (pinned) over edge row 0 made zero-weight
        ii2 = np.zeros((2 * half,), np.int64)
        jj2 = np.zeros((2 * half,), np.int64)
        ii2[:K_], ii2[half:half + K_] = mii, mjj
        jj2[:K_], jj2[half:half + K_] = mjj, mii
        kidx = np.zeros((half,), np.int64)
        kidx[:K_] = kept
        real = np.zeros((2 * half,), bool)
        real[:K_] = real[half:half + K_] = True
        dev = self.device
        ii2, jj2 = to_device(ii2, dev), to_device(jj2, dev)
        kidx_t = to_device(kidx, dev)
        idx, valid, Q = _expand_two_way(*self._stores(), kidx_t)
        valid = valid & to_device(real, dev)[:, None, None]
        slots = to_device(snap.slots(sel), dev, torch.long)
        poses = to_device(sel, dev, torch.long)
        settings = self.settings._replace(pin=pin)
        if self._cache_usable(E):
            among = np.zeros((E,), bool)
            among[kept] = True
            self._refresh_gcache(E, ver, snap, mode, among=among)
            Twc_new, _, _, diverged = gauss_newton_poses_cached(
                snap.T_WC[poses], snap.X[slots], snap.C[slots], snap.n_fused[poses],
                ii2, jj2, self._gf[kidx_t], self._gb[kidx_t], idx, valid, Q, self.K,
                self.img_hw, settings, mode)
        else:
            Cs = snap.C[slots] / torch.clamp_min(
                snap.n_fused[poses][:, None, None].float(), 1.0)
            Twc_new, _, _, diverged = self._dispatch_solve(
                snap.T_WC[poses], snap.X[slots], Cs, ii2, jj2, idx, valid, Q, mode,
                settings)
        self._record_health(diverged, Ppad, pin)
        if s0 > self.settings.pin and (self.keyframes.paging or self._recycle):
            self._recycle_old_edges(s0)
        # the window's poses sit at [pin, pin + window) of the compact array
        return s0, n_kf, snap.generation, Twc_new, pin

    def _buckets(self, n_kf: int, s0: int, ii_k, jj_k):
        """The padded solve of the kept edges (ii_k, jj_k) over the poses
        from ``s0``, as the JAX package pads it: (sel (Ppad,) the keyframe
        of each compact pose, remap (n_kf,) keyframe -> compact pose, pin,
        Ppad, half the edges a direction).  Without a window (``s0`` =
        ``pin``): the keyframes [0, n) and ``pin`` pinned, Ppad =
        ``_bucket(n, pose_bucket_floor)`` capped at the store's capacity
        (``_solve_full``).  With one: the older ends referenced, padded to
        ``_bucket(refs, 8)`` pinned poses, then the window, Ppad =
        ``_bucket(pinpad + window, pose_bucket_floor)``
        (``_solve_windowed``).  Padded poses are copies of compact pose 0
        and no edge touches them.  Kept edges: ``_bucket(kept,
        edge_bucket_floor // 2)`` a direction (the floor at least the
        mesh's size)."""
        lcfg = self.lcfg
        p_floor = int(lcfg.get("pose_bucket_floor", 16))
        e_floor = int(lcfg.get("edge_bucket_floor", 16))
        if self.mesh is not None:
            e_floor = max(e_floor, self.mesh.size)
        half = _bucket(len(ii_k), max(e_floor // 2, 1))
        window = n_kf - s0
        if s0 == self.settings.pin:
            pin = self.settings.pin
            Ppad = min(_bucket(n_kf, p_floor), _bucket(self.keyframes.capacity, 2))
            head = np.arange(n_kf)
            remap = np.arange(n_kf)
        else:
            ends = np.concatenate([ii_k, jj_k])
            old_ref = np.unique(ends[ends < s0])
            if old_ref.size == 0:
                # a window cut off from the past: the newest older pose sets the gauge
                old_ref = np.array([s0 - 1])
            pin = _bucket(int(old_ref.size), 8)
            Ppad = _bucket(pin + window, p_floor)
            head = np.concatenate([old_ref, np.full(pin - old_ref.size, old_ref[0]),
                                   np.arange(s0, n_kf)])
            remap = np.zeros((n_kf,), np.int64)
            remap[old_ref] = np.arange(old_ref.size)
            remap[s0:] = pin + np.arange(window)
        sel = np.concatenate([head, np.full(Ppad - head.size, head[0])]).astype(np.int64)
        return sel, remap, pin, Ppad, half

    def _dispatch_solve(self, Twc, Xs, Cs, ii2, jj2, idx, valid, Q, mode: str,
                        settings=None):
        """The global GN on gathered-in-solve edge fields: edge-sharded over
        the mesh (always dense), else on the store's device."""
        if mode == "calib":
            Xs = constrain_points_to_ray(self.img_hw, Xs, self.K)
        if self.mesh is not None:
            return gauss_newton_poses_sharded(
                self.mesh, Twc, Xs, Cs, ii2, jj2, idx, valid, Q, self.K, self.img_hw,
                settings or self.settings, mode)
        return gauss_newton_poses(Twc, Xs, Cs, ii2, jj2, idx, valid, Q, self.K,
                                  self.img_hw, settings or self.settings, mode)

    # ------------------------------------------------------------------
    # solver health guard
    # ------------------------------------------------------------------

    def _record_health(self, diverged, Ppad: int, pin: int):
        """Keep a PCG-routed solve's ``diverged`` flag (a device scalar) for
        the next solve, which reads it (the dense route is damped to stay
        positive definite and checks its factor, so its flag is not kept; a
        mesh's solve is always dense).  The route follows the padded pose
        count ``Ppad`` and the solve's ``pin``, as in ``global_gn``."""
        if self.mesh is None and routes_pcg(self.settings._replace(pin=pin), Ppad):
            self._health_pending = diverged

    def _consume_health(self) -> bool:
        """True iff the previous PCG-routed solve diverged: one host read of
        its flag, at the next solve, as the JAX package reads it."""
        if self._health_pending is None:
            return False
        div = bool(to_host(self._health_pending)[0])
        self._health_pending = None
        if div:
            self.n_recoveries += 1
            print("global GN: monotone-cost guard tripped on the PCG route; "
                  "solving this one dense", file=sys.stderr)
        return div

    # ------------------------------------------------------------------
    # gathered-point cache
    # ------------------------------------------------------------------

    def _cache_usable(self, E: int) -> bool:
        """Single-device solves only: the mesh shards raw edge fields."""
        return self._gcache_on and self.mesh is None and E <= self._gcache_max

    def _ensure_gcache(self, E: int):
        """Grow the cache to hold E edges.  Unwritten rows hold finite dummy
        points (ones), so zero-weight rows never feed NaN into a solve."""
        if self._gf is not None and self._gcache_cap >= E:
            return
        cap = _bucket(E, max(self._gcache_cap, 1))
        fresh = lambda n: torch.ones((n, self.N, 4), dtype=torch.float32,
                                     device=self.device)
        if self._gf is None:
            self._gf, self._gb = fresh(cap), fresh(cap)
        else:
            pad = cap - self._gcache_cap
            self._gf = torch.cat([self._gf, fresh(pad)])
            self._gb = torch.cat([self._gb, fresh(pad)])
        self._gcache_cap = cap

    def _refresh_gcache(self, E: int, ver, snap, mode: str, among=None):
        """Re-gather the rows of edges whose source keyframes changed; with
        ``among`` (a mask over the E edges), only of those edges (a window's:
        the others stay stale until a solve needs them)."""
        self._ensure_gcache(E)
        ii_e = self.ii[:E]
        jj_e = self.jj[:E]
        stale = (self._stamp_f[:E] != ver[ii_e]) | (self._stamp_b[:E] != ver[jj_e])
        if among is not None:
            stale &= among
        sidx = np.nonzero(stale)[0]
        if sidx.size == 0:
            return
        dev = self.device
        pos = to_device(sidx, dev, torch.long)
        _refresh_gather(
            self._gf, self._gb, snap.X, snap.C, self.K,
            to_device(snap.slots(ii_e[sidx]), dev, torch.long),
            to_device(snap.slots(jj_e[sidx]), dev, torch.long),
            self.idx_ii2jj[pos], self.idx_jj2ii[pos], pos, self.img_hw, mode)
        self._stamp_f[sidx] = ver[ii_e[sidx]]
        self._stamp_b[sidx] = ver[jj_e[sidx]]

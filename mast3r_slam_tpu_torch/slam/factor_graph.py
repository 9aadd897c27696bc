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

``solve`` expands the stored edges both ways and runs the global
Gauss-Newton over every keyframe pose, through the gathered-point cache
when it applies, then writes the solved poses back to the keyframe store
(refused if a relocalisation popped a keyframe meanwhile).

The edge store is preallocated tensors on the device written in place, and
a solve takes exactly the stored edges and keyframes: the JAX package pads
both to power-of-two buckets only to bound its compiled programs.  Strided
matching, edge recycling, windowed solves, paging and a mesh raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import sys
import threading
from typing import List, Tuple

import numpy as np
import torch

from ..geometry import constrain_points_to_ray
from ..ops import matching
from ..ops.global_gn import GlobalGNSettings, gauss_newton_poses, gauss_newton_poses_cached
from ..ops.matching import match_kwargs
from .frame import Keyframes

_ITEM8 = "ROADMAP Queue 1, item 8"
_WINDOWED = f"{_ITEM8}e: windowed solves and edge recycling"


def _bucket(n: int, lo: int = 1) -> int:
    """The least ``lo * 2**k`` that is >= n."""
    b = lo
    while b < n:
        b *= 2
    return b


def _store_edges(stores, rows, new) -> None:
    """Write new edges' fields into rows ``rows`` of the edge store, in place.
    ``stores`` and ``new`` are matching tuples of the six per-edge fields."""
    rows_t = torch.as_tensor(rows, device=stores[0].device).long()
    for dst, src in zip(stores, new):
        dst[rows_t] = src.to(dst)


def _refresh_gather(gf, gb, Xs, C_raw, K, eii, ejj, idx_f, idx_b, pos, img_hw,
                    mode: str) -> None:
    """Re-gather the cached [X | C_raw] rows of the edges ``pos``, in place.
    eii / ejj (S,) source keyframes; idx_f / idx_b (S, N) match indices.
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


def _expand_two_way(idx_f, idx_b, vf, vb, qf, qb, n_edges: int):
    """The first ``n_edges`` stored edges both ways, in the layout
    [forward(0..E) | backward(0..E)]: (idx (2E, N), valid (2E, N, 1),
    Q (2E, N, 1))."""
    E = n_edges
    return (torch.cat([idx_f[:E], idx_b[:E]]), torch.cat([vf[:E], vb[:E]]),
            torch.cat([qf[:E], qb[:E]]))


@torch.no_grad()
def _add_factors_compute(img_hw, res, Q_conf: float, mk: dict):
    """Two-way matching + Q aggregation for B pairs: the matcher runs once
    on the 2B images [ii | jj] (the JAX package unrolls it per pair for a
    TPU lowering reason; the indices are the same)."""
    H, W = img_hw
    N = H * W
    (Xii, _, Dii, Qii), (Xji, _, Dji, Qji), (Xjj, _, Djj, Qjj), (Xij, _, Dij, Qij) = res
    B = Xii.shape[0]
    idx, valid = matching.match(
        torch.cat([Xii, Xjj]), torch.cat([Xji, Xij]),
        torch.cat([Dii, Djj]), torch.cat([Dji, Dij]), **mk)
    idx_i2j, idx_j2i = idx[:B], idx[B:]
    valid_j, valid_i = valid[:B], valid[B:]

    def agg(Q_src, idx_, Q_dst):
        g = torch.gather(Q_src.reshape(B, N, 1), 1, idx_.long()[..., None])
        return torch.sqrt(g * Q_dst.reshape(B, N, 1))

    Qj = agg(Qii, idx_i2j, Qji)
    Qi = agg(Qjj, idx_j2i, Qij)
    match_frac_j = (valid_j & (Qj > Q_conf)).float().mean(dim=(1, 2))
    match_frac_i = (valid_i & (Qi > Q_conf)).float().mean(dim=(1, 2))
    return dict(idx_i2j=idx_i2j, idx_j2i=idx_j2i, valid_j=valid_j, valid_i=valid_i,
                Qj=Qj, Qi=Qi, match_frac_j=match_frac_j, match_frac_i=match_frac_i)


@torch.no_grad()
def _add_factors_forward(img_hw, res, Q_conf: float, mk: dict):
    """Forward-only (i -> j) matching and Q aggregation for B pairs: the
    forward half of ``_add_factors_compute`` (the one-way and reuse paths)."""
    N = img_hw[0] * img_hw[1]
    (Xii, _, Dii, Qii), (Xji, _, Dji, Qji) = res
    B = Xii.shape[0]
    idx_i2j, valid_j = matching.match(Xii, Xji, Dii, Dji, **mk)
    g = torch.gather(Qii.reshape(B, N, 1), 1, idx_i2j.long()[..., None])
    Qj = torch.sqrt(g * Qji.reshape(B, N, 1))
    match_frac_j = (valid_j & (Qj > Q_conf)).float().mean(dim=(1, 2))
    return dict(idx_i2j=idx_i2j, valid_j=valid_j, Qj=Qj, match_frac_j=match_frac_j)


def _masked(keep, valid, Q):
    """An edge's weight fields with its on-device gate verdict applied: a
    rejected edge keeps valid False and Q 0, zero weight in the solve."""
    m = keep[:, None, None]
    return valid & m, Q * m.to(Q.dtype)


class FactorGraph:
    """Edges between keyframes and the global pose solve over them."""

    def __init__(self, model, cfg, keyframes: Keyframes, img_hw: Tuple[int, int],
                 K=None, edge_capacity: int = 1024, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh is not ported yet (ROADMAP Queue 1, item 12: multi-GPU)")
        lcfg = cfg["local_opt"]
        if lcfg.get("edge_recycle", False):
            raise NotImplementedError(
                f"local_opt.edge_recycle: {lcfg['edge_recycle']!r} is not ported yet "
                f"({_WINDOWED})")
        if int(lcfg.get("pixel_stride", 1)) > 1:
            raise NotImplementedError(
                f"local_opt.pixel_stride: {lcfg['pixel_stride']!r} is not ported "
                f"yet ({_ITEM8}d: strided backend matching)")
        self.model = model
        self.cfg = cfg
        self.lcfg = lcfg
        self.settings = GlobalGNSettings.from_config(cfg)
        self.keyframes = keyframes
        self.device = keyframes.device
        self.img_hw = tuple(img_hw)
        self.K = (K if K is not None
                  else torch.eye(3, dtype=torch.float32, device=self.device))
        # free poses a solve may take; beyond it the JAX graph solves a window
        self.window_size = int(float(lcfg.get("window_size", 0) or 0))
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

    def _stores(self):
        return (self.idx_ii2jj, self.idx_jj2ii, self.valid_match_j,
                self.valid_match_i, self.Q_ii2jj, self.Q_jj2ii)

    # ------------------------------------------------------------------
    # add factors
    # ------------------------------------------------------------------

    def add_factors(self, ii: List[int], jj: List[int], min_match_frac: float,
                    is_reloc: bool = False, strict: bool = None,
                    captures=None) -> bool:
        """Inference, matching, gate and store for the pairs (ii[b], jj[b]).
        An edge is kept when both match fractions reach ``min_match_frac``
        or it is consecutive (jj = ii + 1); with ``strict`` one rejected
        edge rejects them all.  ``is_reloc`` marks relocalisation edges (the
        new keyframe as ii, so never consecutive), which always take the
        bidirectional symmetric path; ``strict`` defaults to it.  Otherwise
        the ``speed`` switches pick each pair's path (see the module
        docstring); ``captures`` maps (i, j) to the tracker's (idx, valid, Q)
        of j's match against i.  Returns whether any edge was stored."""
        if strict is None:
            strict = is_reloc
        B = len(ii)
        if B == 0:
            return False
        snap = self.keyframes.snapshot()
        ii_arr = np.asarray(ii, dtype=np.int32)
        jj_arr = np.asarray(jj, dtype=np.int32)
        lcfg = self.lcfg
        fast = not is_reloc
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

    def _compute_symmetric(self, snap, ii_arr, jj_arr):
        ii_t = torch.as_tensor(ii_arr, device=self.device).long()
        jj_t = torch.as_tensor(jj_arr, device=self.device).long()
        res = self.model.symmetric(snap.feat[ii_t], snap.pos[ii_t],
                                   snap.feat[jj_t], snap.pos[jj_t])
        return _add_factors_compute(self.img_hw, res, float(self.lcfg["Q_conf"]),
                                    match_kwargs(self.cfg))

    def _compute_oneway(self, snap, ii_arr, jj_arr):
        """One asymmetric decode and forward matching a pair."""
        ii_t = torch.as_tensor(ii_arr, device=self.device).long()
        jj_t = torch.as_tensor(jj_arr, device=self.device).long()
        res = self.model.asymmetric(snap.feat[ii_t], snap.pos[ii_t],
                                    snap.feat[jj_t], snap.pos[jj_t])
        return _add_factors_forward(self.img_hw, res, float(self.lcfg["Q_conf"]),
                                    match_kwargs(self.cfg))

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
        consec = torch.as_tensor(ii_arr == (jj_arr - 1), device=self.device)
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
        """B fresh edge rows off the end of the store, growing it if needed."""
        self._ensure_capacity(self.n_edges + B)
        rows = np.arange(self.n_edges, self.n_edges + B, dtype=np.int32)
        self.n_edges += B
        return rows

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

    def solve(self, mode: str = None):
        """Two-way edge expansion, global GN over all keyframe poses (the
        first ``pin`` stay fixed), pose write-back."""
        if mode is None:
            mode = "calib" if self.cfg["use_calib"] else "rays"
        E = self.n_edges
        ver = self.keyframes.pm_version.copy()
        snap = self.keyframes.snapshot()
        n_kf = snap.n
        if E == 0 or n_kf <= self.settings.pin:
            return
        if self._consume_health():
            # the previous PCG-routed solve raised the cost (its step was
            # reverted): solve this one on the dense route
            old = self.settings
            window = min(self.window_size or 10 ** 9, old.dense_max_poses)
            self._check_window(n_kf, window, "the health guard's dense recovery")
            self.settings = old._replace(solver="dense")
            try:
                self._solve_full(mode, snap, E, n_kf, ver)
            finally:
                self.settings = old
            return
        self._check_window(n_kf, self.window_size, "local_opt.window_size")
        self._solve_full(mode, snap, E, n_kf, ver)

    def _check_window(self, n_kf: int, window: int, what: str):
        if window and (n_kf - self.settings.pin) > window:
            raise NotImplementedError(
                f"{what}: a window of {window} free poses is smaller than the "
                f"graph's {n_kf - self.settings.pin}, and the windowed solve is "
                f"not ported yet ({_WINDOWED})")

    def _solve_full(self, mode: str, snap, E: int, n_kf: int, ver):
        dev = self.device
        ii2 = torch.as_tensor(np.concatenate([self.ii[:E], self.jj[:E]]), device=dev)
        jj2 = torch.as_tensor(np.concatenate([self.jj[:E], self.ii[:E]]), device=dev)
        idx, valid, Q = _expand_two_way(*self._stores(), E)
        if self._cache_usable(E):
            self._refresh_gcache(E, ver, snap, mode)
            Twc_new, _, _, diverged = gauss_newton_poses_cached(
                snap.T_WC[:n_kf], snap.X[:n_kf], snap.C[:n_kf], snap.n_fused[:n_kf],
                ii2, jj2, self._gf[:E], self._gb[:E], idx, valid, Q, self.K,
                self.img_hw, self.settings, mode)
        else:
            Cs = snap.C[:n_kf] / torch.clamp_min(
                snap.n_fused[:n_kf, None, None].float(), 1.0)
            Twc_new, _, _, diverged = self._dispatch_solve(
                snap.T_WC[:n_kf], snap.X[:n_kf], Cs, ii2, jj2, idx, valid, Q, mode)
        self._record_health(diverged, n_kf)
        self.keyframes.write_back_poses(self.settings.pin, n_kf, snap.generation, Twc_new)

    def _dispatch_solve(self, Twc, Xs, Cs, ii2, jj2, idx, valid, Q, mode: str):
        """The global GN on gathered-in-solve edge fields (one device)."""
        if mode == "calib":
            Xs = constrain_points_to_ray(self.img_hw, Xs, self.K)
        return gauss_newton_poses(Twc, Xs, Cs, ii2, jj2, idx, valid, Q, self.K,
                                  self.img_hw, self.settings, mode)

    # ------------------------------------------------------------------
    # solver health guard
    # ------------------------------------------------------------------

    def _record_health(self, diverged: bool, P: int):
        """Keep a PCG-routed solve's ``diverged`` flag for the next solve
        (the dense route is damped to stay positive definite and checks its
        factor, so its flag is not kept)."""
        s = self.settings
        routed_pcg = s.solver == "pcg" or (
            s.solver == "auto" and (P - s.pin) > s.dense_max_poses)
        if routed_pcg:
            self._health_pending = diverged

    def _consume_health(self) -> bool:
        """True iff the previous PCG-routed solve diverged."""
        if self._health_pending is None:
            return False
        div = bool(self._health_pending)
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
        return self._gcache_on and E <= self._gcache_max

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

    def _refresh_gcache(self, E: int, ver, snap, mode: str):
        """Re-gather the rows of edges whose source keyframes changed."""
        self._ensure_gcache(E)
        ii_e = self.ii[:E]
        jj_e = self.jj[:E]
        stale = (self._stamp_f[:E] != ver[ii_e]) | (self._stamp_b[:E] != ver[jj_e])
        sidx = np.nonzero(stale)[0]
        if sidx.size == 0:
            return
        dev = self.device
        pos = torch.as_tensor(sidx, device=dev).long()
        _refresh_gather(
            self._gf, self._gb, snap.X, snap.C, self.K,
            torch.as_tensor(ii_e[sidx], device=dev).long(),
            torch.as_tensor(jj_e[sidx], device=dev).long(),
            self.idx_ii2jj[pos], self.idx_jj2ii[pos], pos, self.img_hw, mode)
        self._stamp_f[sidx] = ver[ii_e[sidx]]
        self._stamp_b[sidx] = ver[jj_e[sidx]]

"""Frames, pointmap fusion and the keyframe store (port of ``slam/frame.py``).

``fuse_pointmap`` covers all six filtering modes.  ``Keyframes`` is the
SoA store: preallocated tensors on the device, written IN PLACE rather
than rebuilt the functional way the JAX package does, which would copy the
whole store on every write.  Capacity doubles when it runs out.  With
``device_budget`` (``engine.device_keyframes``) the per-keyframe rows X,
C, feat and pos live in a fixed pool of slots and older keyframes page to
pinned host memory (``slot_of``, ``ensure_resident``, ``pointmap_np``).
The factor graph reads the store through ``snapshot`` and ``pm_version``
and writes solved poses back with ``write_back_poses``; relocalisation
appends, snaps (``update_pose``) or pops (``pop_last``) a keyframe, and
retrieval reads a keyframe's tokens (``get_feat``).

The store is shared with the backend's worker thread
(``single_thread: False``).  Its own ``RLock`` guards every write and every
read that hands tensors out.  Because the writes are in place, a snapshot
CLONES what a writer may change under it (the first ``n`` slots' pointmaps,
confidences, counters and poses; a JAX snapshot is references only because
JAX arrays are immutable), so a backend task never reads a pointmap that
the tracker's next fusion half overwrote.  ``generation`` is bumped by
``pop_last``; ``write_back_poses`` refuses a solve whose snapshot is of
another generation.  On CUDA the store's tensors are written and cloned on
the stream that built the store (the frontend's): a caller on another
stream (the backend's) first waits for its inputs there, and a snapshot
makes the caller's stream wait for the clones, with ``record_stream`` on
every tensor that crosses.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from enum import IntEnum
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import record_on, resolve_device, to_host
from ..lie import sim3
from ..utils.numerics import vnorm


class Mode(IntEnum):
    INIT = 0
    TRACKING = 1
    RELOC = 2
    TERMINATED = 3


FILTERING_MODES = (
    "first", "recent", "best_score", "indep_conf",
    "weighted_pointmap", "weighted_spherical",
)


def pointmap_score(C_new, score_mode: str = "median"):
    """Aggregate confidence for ``best_score`` fusion.  The median averages
    the two middle values of an even count, as ``jnp.median`` does
    (``torch.median`` would return the lower one)."""
    if score_mode == "median":
        return torch.quantile(C_new.reshape(-1).float(), 0.5)
    if score_mode == "mean":
        return torch.mean(C_new)
    raise ValueError(f"unknown filtering_score {score_mode}")


def _to_sph(P):
    r = vnorm(P)
    x, y, z = P[..., 0:1], P[..., 1:2], P[..., 2:3]
    return torch.cat(
        [r, torch.atan2(y, x),
         torch.arccos(torch.clamp(z / torch.clamp_min(r, 1e-12), -1, 1))], dim=-1)


def _to_cart(s):
    r, phi, theta = s[..., 0:1], s[..., 1:2], s[..., 2:3]
    st = torch.sin(theta)
    return torch.cat(
        [r * st * torch.cos(phi), r * st * torch.sin(phi), r * torch.cos(theta)], dim=-1)


def _scalar(x, dtype, device):
    """A 0-d tensor of ``x``: a Python number is filled in on the device
    (``torch.as_tensor`` would copy it from the host and, on the card,
    wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _put(dst, idx: int, value) -> None:
    """dst[idx] = value, a Python number filled in on the device (an
    assignment would copy it from the host and wait for the stream)."""
    dst[idx:idx + 1].fill_(value)


class KeyframeFeat(NamedTuple):
    """What retrieval reads of a keyframe (``Keyframes.get_feat``)."""
    feat: torch.Tensor  # (1, P, D) encoder tokens


def fuse_pointmap(X, C, n_fused, n_updates, X_new, C_new, score=None,
                  mode: str = "weighted_pointmap", score_mode: str = "median"):
    """One fusion step of a canonical pointmap, every mode on the device.

    X, X_new: (N, 3); C, C_new: (N, 1); n_fused / n_updates: int32 scalars;
    score: f32 scalar (-inf when unused).  Returns
    (X', C', n_fused', n_updates', score'), with the JAX package's semantics:
    the first observation installs the new map; then ``first`` replaces once
    more on the second observation, ``recent`` always replaces,
    ``best_score`` replaces when the new aggregate confidence beats the
    stored score, ``indep_conf`` keeps the higher-confidence pixel (N reset
    to 1), ``weighted_pointmap`` confidence-averages, ``weighted_spherical``
    averages in (r, phi, theta).
    """
    dev = X.device
    n_fused = _scalar(n_fused, torch.int32, dev)
    n_updates = _scalar(n_updates, torch.int32, dev)
    if score is None:
        score = float("-inf")
    score = _scalar(score, torch.float32, dev)
    one = torch.ones_like(n_fused)

    if mode == "first":
        take = n_updates == 1
        Xo = torch.where(take, X_new, X)
        Co = torch.where(take, C_new, C)
        no = torch.where(take, one, n_fused)
        so = score
    elif mode == "recent":
        Xo, Co, no, so = X_new, C_new, one, score
    elif mode == "best_score":
        new_score = pointmap_score(C_new, score_mode)
        take = new_score > score
        Xo = torch.where(take, X_new, X)
        Co = torch.where(take, C_new, C)
        no = torch.where(take, one, n_fused)
        so = torch.maximum(new_score, score)
    elif mode == "indep_conf":
        take = C_new > C
        Xo = torch.where(take, X_new, X)
        Co = torch.where(take, C_new, C)
        no = one
        so = score
    elif mode == "weighted_pointmap":
        Xo = (C * X + C_new * X_new) / (C + C_new)
        Co = C + C_new
        no = n_fused + 1
        so = score
    elif mode == "weighted_spherical":
        s = (C * _to_sph(X) + C_new * _to_sph(X_new)) / (C + C_new)
        Xo = _to_cart(s)
        Co = C + C_new
        no = n_fused + 1
        so = score
    else:
        raise ValueError(f"unknown filtering_mode {mode}")

    is_init = n_updates == 0
    init_score = pointmap_score(C_new, score_mode) if mode == "best_score" else score
    return (
        torch.where(is_init, X_new, Xo),
        torch.where(is_init, C_new, Co),
        torch.where(is_init, one, no),
        n_updates + 1,
        torch.where(is_init, init_score, so),
    )


@dataclasses.dataclass
class Frame:
    """One frame's tensors and fusion state."""

    frame_id: int
    img: Optional[torch.Tensor]           # (3, H, W) normalised
    T_WC: torch.Tensor                    # (8,) Sim3
    X_canon: Optional[torch.Tensor] = None  # (N, 3)
    C: Optional[torch.Tensor] = None        # (N, 1) summed confidence
    n_fused: int = 0
    n_updates: int = 0
    feat: Optional[torch.Tensor] = None     # (1, P, D) encoder tokens
    pos: Optional[torch.Tensor] = None      # (1, P, 2)
    K: Optional[torch.Tensor] = None
    score: float = -np.inf
    uimg: Optional[np.ndarray] = None
    # host copy of T_WC from the tracker's single stats read
    T_WC_np: Optional[np.ndarray] = None

    def update_pointmap(self, X_new, C_new, mode="weighted_pointmap",
                        score_mode="median"):
        if self.n_updates == 0 or self.X_canon is None:
            self.X_canon, self.C = X_new, C_new
            self.n_fused, self.n_updates = 1, 1
            if mode == "best_score":
                self.score = float(pointmap_score(C_new, score_mode))
            return
        X, C, n, nu, score = fuse_pointmap(
            self.X_canon, self.C, self.n_fused, self.n_updates, X_new, C_new,
            score=self.score, mode=mode, score_mode=score_mode)
        self.X_canon, self.C = X, C
        self.n_fused = int(n)
        self.n_updates = int(nu)
        self.score = float(score)


class KeyframeSnapshot(NamedTuple):
    """The store at one moment (see ``Keyframes.snapshot``): clones of the
    first ``n`` keyframes' T_WC and n_fused and of the pointmap slots X and C,
    which ``slot_of`` indexes.  feat and pos are references without paging
    (a slot's tokens never change while a snapshot of it lives: only
    relocalisation pops and re-appends a slot, and it holds the engine's
    backend lock) and clones with paging, where an eviction hands a slot to
    another keyframe and writes it in place.  With paging, ``host_rows``
    holds the evicted keyframes' host buffers as they stood (a buffer is
    never written after its eviction), so ``with_resident`` can bring any
    of them in without the store."""

    n: int
    generation: int
    T_WC: torch.Tensor
    X: torch.Tensor
    C: torch.Tensor
    n_fused: torch.Tensor
    feat: torch.Tensor
    pos: torch.Tensor
    slot_of: np.ndarray
    host_rows: Optional[dict] = None

    def slots(self, idxs) -> np.ndarray:
        """The slots of keyframes ``idxs``.  Raises if one was not resident
        when the snapshot was taken: slot -1 would index the last slot."""
        idxs = np.asarray(idxs, dtype=np.int64)
        s = self.slot_of[idxs]
        if (s < 0).any():
            raise RuntimeError(f"keyframes {idxs[s < 0].tolist()} are not resident in "
                               "this snapshot")
        return s

    def with_resident(self, idxs) -> "KeyframeSnapshot":
        """This snapshot with the evicted keyframes among ``idxs`` appended
        as slots, copied from its host buffers: the store's
        ``ensure_resident`` for a snapshot, which leaves the store as it is."""
        out = sorted({int(i) for i in idxs if self.slot_of[int(i)] < 0})
        if not out:
            return self
        rows = []
        for i in out:
            h = self.host_rows[i]
            if h["event"] is not None:
                h["event"].synchronize()
            rows.append(h)
        slot_of = self.slot_of.copy()
        slot_of[out] = np.arange(self.X.shape[0], self.X.shape[0] + len(out))

        def grown(a, name):
            return torch.cat([a, torch.stack([h[name] for h in rows]).to(a)])

        return self._replace(X=grown(self.X, "X"), C=grown(self.C, "C"),
                             feat=grown(self.feat, "feat"), pos=grown(self.pos, "pos"),
                             slot_of=slot_of)


_PAGED = ("X", "C", "feat", "pos")  # the per-keyframe rows a slot holds


class Keyframes:
    """Device-resident SoA keyframe store of ``capacity`` keyframes.

    ``device_budget`` > 0 pages the store: X, C, feat and pos live in a pool
    of that many device slots (``dcap``), ``slot_of`` maps a keyframe to its
    slot (-1: evicted to host memory), and when a slot is needed the oldest
    resident keyframe outside the ``keep_recent`` newest, the ``sticky`` set
    and the keyframes being brought back is evicted; ``ensure_resident``
    uploads evicted keyframes again.  An eviction copies the slot into
    pinned host buffers on the store's stream, after every write queued
    there, unless the host copy of that pointmap version exists already;
    an upload copies back on the same stream, before any later reader's
    work.  Poses and counters stay resident for every keyframe.  Without a
    budget the pool grows with ``capacity`` and a keyframe's slot is its
    index."""

    def __init__(self, capacity: int, num_pixels: int, num_patches: int,
                 feat_dim: int, device, dtype=torch.float32, device_budget: int = 0,
                 keep_recent: int = 64):
        self.capacity = capacity
        self.num_pixels = num_pixels
        self.device = resolve_device(device)
        self.n = 0
        self.lock = threading.RLock()
        self.generation = 0
        dev = self.device
        # the stream every store write and snapshot clone runs on
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self.paging = bool(device_budget)
        self.dcap = min(device_budget, capacity) if self.paging else capacity
        self.keep_recent = keep_recent
        # old keyframes a window's edges pin as context: evicting them would
        # upload them again at every solve (the factor graph sets it)
        self.sticky: set = set()
        self.slot_of = np.full((capacity,), -1, dtype=np.int32)
        self._slot_owner = np.full((self.dcap,), -1, dtype=np.int32)
        self._free_slots = set(range(self.dcap))
        # evicted rows: idx -> dict(X, C, feat, pos, ver, event)
        self._host_rows: dict = {}
        self.n_evictions = 0
        self.frame_id = np.full((capacity,), -1, dtype=np.int64)
        self.T_WC = sim3.identity((capacity,), dtype=dtype, device=dev)
        self.X = torch.zeros((self.dcap, num_pixels, 3), dtype=dtype, device=dev)
        self.C = torch.zeros((self.dcap, num_pixels, 1), dtype=dtype, device=dev)
        self.n_fused = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        self.n_updates = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        self.score = torch.full((capacity,), float("-inf"), dtype=dtype, device=dev)
        self.feat = torch.zeros((self.dcap, num_patches, feat_dim), dtype=dtype, device=dev)
        self.pos = torch.zeros((self.dcap, num_patches, 2), dtype=torch.int32, device=dev)
        self.K: Optional[torch.Tensor] = None
        self.uimgs = [None] * capacity
        # per-keyframe pointmap version, bumped on every X/C write: the
        # factor graph's gathered-point cache re-gathers an edge when a
        # version it was stamped with has moved
        self.pm_version = np.zeros((capacity,), dtype=np.int64)

    def __len__(self):
        return self.n

    @contextmanager
    def _on_store_stream(self, *inputs):
        """Hold the lock; on CUDA, run the body on the store's stream after
        the caller's stream has produced ``inputs``."""
        with self.lock:
            cur = (torch.cuda.current_stream(self.device)
                   if self._stream is not None else None)
            if cur is None or cur == self._stream:
                yield
                return
            self._stream.wait_stream(cur)
            record_on(self._stream, self.device, inputs)
            with torch.cuda.stream(self._stream):
                yield

    def _hand_out(self, *tensors):
        """Make the caller's stream wait for the store's stream before it
        reads ``tensors`` (clones made, or references taken, under the lock)."""
        if self._stream is None:
            return
        cur = torch.cuda.current_stream(self.device)
        if cur == self._stream:
            return
        cur.wait_stream(self._stream)
        for t in tensors:
            t.record_stream(cur)

    def append(self, frame: Frame) -> int:
        with self.lock:
            idx = self.n
            self._ensure_capacity(idx + 1)
            self.set_frame(idx, frame)
            self.n = idx + 1
            return idx

    def _ensure_capacity(self, needed: int):
        """Double the store (copying it) when ``needed`` keyframes do not fit;
        a paged pool keeps its slots."""
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        pad = new_cap - self.capacity

        def grow(a, fill=0):
            return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

        with self._on_store_stream():
            self.T_WC = torch.cat([self.T_WC, sim3.identity(
                (pad,), dtype=self.T_WC.dtype, device=self.device)])
            self.n_fused = grow(self.n_fused)
            self.n_updates = grow(self.n_updates)
            self.score = grow(self.score, float("-inf"))
            self.frame_id = np.concatenate([self.frame_id, np.full((pad,), -1, np.int64)])
            self.pm_version = np.concatenate([self.pm_version, np.zeros((pad,), np.int64)])
            self.slot_of = np.concatenate([self.slot_of, np.full((pad,), -1, np.int32)])
            self.uimgs = self.uimgs + [None] * pad
            self.capacity = new_cap
            if not self.paging:
                self._grow_paged(new_cap)

    def _grow_paged(self, new_dcap: int):
        """Grow the slot pool, to at most ``capacity`` slots (no more can be
        owned).  Caller holds the lock on the store's stream."""
        new_dcap = min(new_dcap, self.capacity)
        pad = new_dcap - self.dcap
        if pad <= 0:
            return
        for name in _PAGED:
            a = getattr(self, name)
            setattr(self, name, torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]))
        self._slot_owner = np.concatenate([self._slot_owner, np.full(pad, -1, np.int32)])
        self._free_slots.update(range(self.dcap, new_dcap))
        self.dcap = new_dcap

    # ------------------------------------------------------------------
    # paging
    # ------------------------------------------------------------------

    def device_bytes(self) -> int:
        """Bytes of the store's device tensors (what the paging budget bounds)."""
        return sum(a.numel() * a.element_size() for a in (
            self.X, self.C, self.feat, self.pos, self.T_WC, self.n_fused,
            self.n_updates, self.score))

    def _alloc_slot(self, idx: int, protect=()) -> int:
        """A slot for keyframe ``idx``, evicting if the pool is full.  Slot ==
        idx while that one is free, so the mapping stays the identity until
        the pool is contended.  Caller holds the lock on the store's stream."""
        if not self._free_slots:
            victim = self._pick_victim(protect)
            if victim is None:
                # nothing evictable (a window wider than the pool): grow it
                print("keyframe paging: no evictable keyframe; growing the device "
                      f"pool past its budget ({self.dcap} slots)")
                self._grow_paged(self.dcap * 2)
            else:
                self._evict_locked(victim)
        if not self._free_slots:
            raise RuntimeError(f"keyframe paging: no device slot for keyframe {idx} "
                               f"({self.dcap} slots, capacity {self.capacity})")
        slot = idx if idx in self._free_slots else min(self._free_slots)
        self._free_slots.remove(slot)
        self.slot_of[idx] = slot
        self._slot_owner[slot] = idx
        return slot

    def _pick_victim(self, protect=()):
        """The oldest resident keyframe outside keep-recent, sticky and protect."""
        recent_floor = self.n - self.keep_recent
        for i in np.sort(self._slot_owner[self._slot_owner >= 0]):
            i = int(i)
            if i < recent_floor and i not in self.sticky and i not in protect:
                return i
        return None

    def _evict_locked(self, idx: int):
        """Move keyframe ``idx``'s rows to pinned host buffers and free its
        slot; the copy is skipped when the host copy of its pointmap version
        exists.  Caller holds the lock on the store's stream."""
        slot = int(self.slot_of[idx])
        ver = int(self.pm_version[idx])
        h = self._host_rows.get(idx)
        if h is None or h["ver"] != ver:
            h = dict(ver=ver, event=None)
            for name in _PAGED:
                src = getattr(self, name)[slot]
                if src.is_cuda:
                    dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                    dst.copy_(src, non_blocking=True)
                else:
                    dst = src.clone()
                h[name] = dst
            if self._stream is not None:
                h["event"] = torch.cuda.Event()
                h["event"].record(self._stream)
            self._host_rows[idx] = h
        self.slot_of[idx] = -1
        self._slot_owner[slot] = -1
        self._free_slots.add(slot)
        self.n_evictions += 1

    def ensure_resident(self, idxs) -> None:
        """Upload the evicted keyframes among ``idxs`` into slots again (loop
        closure and relocalisation to old keyframes, a window's pinned
        context); none of ``idxs`` is evicted to make room."""
        idxs = sorted({int(i) for i in idxs})
        with self._on_store_stream():
            for idx in idxs:
                if idx >= self.n or self.slot_of[idx] >= 0:
                    continue
                h = self._host_rows[idx]
                slot = self._alloc_slot(idx, protect=idxs)
                for name in _PAGED:
                    getattr(self, name)[slot].copy_(h[name], non_blocking=True)

    def is_resident(self, idx: int) -> bool:
        return bool(self.slot_of[idx] >= 0)

    def _rows(self, idx: int, names) -> tuple:
        """Host copies of keyframe ``idx``'s rows ``names`` as numpy, from its
        slot or, evicted, from its host buffers."""
        with self._on_store_stream():
            slot = int(self.slot_of[idx])
            if slot >= 0:  # .cpu() runs on the store's stream and waits
                return tuple(getattr(self, name)[slot].cpu().numpy() for name in names)
            h = self._host_rows[idx]
        if h["event"] is not None:
            h["event"].synchronize()
        return tuple(h[name].numpy() for name in names)

    def pointmap_np(self, idx: int):
        """(X, C_raw) of one keyframe as numpy, resident or evicted."""
        return self._rows(idx, ("X", "C"))

    def feat_np(self, idx: int):
        """(feat, pos) of one keyframe as numpy, resident or evicted."""
        return self._rows(idx, ("feat", "pos"))

    def load_rows(self, X, C, feat, pos):
        """Lay out the rows of all ``n`` keyframes (numpy, keyframe order) as
        a checkpoint restores them: the newest min(n, dcap) in slots 0.., the
        older ones evicted to host buffers.  Caller holds the lock, has set
        ``n`` and bumped ``pm_version``."""
        n = self.n
        m = min(n, self.dcap)
        first = n - m
        rows = dict(X=X, C=C, feat=feat, pos=pos)
        with self._on_store_stream():
            for name in _PAGED:
                dst = getattr(self, name)
                dst[:m] = torch.as_tensor(np.asarray(rows[name][first:n])).to(dst)
            self.slot_of[:] = -1
            self.slot_of[first:n] = np.arange(m, dtype=np.int32)
            self._slot_owner[:] = -1
            self._slot_owner[:m] = np.arange(first, n, dtype=np.int32)
            self._free_slots = set(range(m, self.dcap))
            self.sticky = set()
            self._host_rows = {}
            pin = self._stream is not None
            for i in range(first):
                h = dict(ver=int(self.pm_version[i]), event=None)
                for name in _PAGED:
                    a = torch.as_tensor(np.array(rows[name][i])).to(getattr(self, name).dtype)
                    h[name] = a.pin_memory() if pin else a
                self._host_rows[i] = h

    def _slot(self, idx: int, what: str) -> int:
        slot = int(self.slot_of[idx])
        if slot < 0:
            raise RuntimeError(f"{what}: keyframe {idx} is evicted")
        return slot

    # ------------------------------------------------------------------

    def set_frame(self, idx: int, frame: Frame):
        with self._on_store_stream(frame.T_WC, frame.X_canon, frame.C, frame.feat,
                                   frame.pos):
            self.frame_id[idx] = frame.frame_id
            self.pm_version[idx] += 1
            slot = int(self.slot_of[idx])
            if slot < 0:
                slot = self._alloc_slot(idx)
            self._host_rows.pop(idx, None)  # any host copy is stale now
            self.T_WC[idx] = frame.T_WC.to(self.T_WC)
            self.X[slot] = frame.X_canon.to(self.X)
            self.C[slot] = frame.C.to(self.C)
            _put(self.n_fused, idx, frame.n_fused)
            _put(self.n_updates, idx, frame.n_updates)
            _put(self.score, idx, frame.score)
            self.feat[slot] = frame.feat[0].to(self.feat)
            self.pos[slot] = frame.pos[0].to(self.pos)
            self.uimgs[idx] = frame.uimg

    def last_idx(self) -> int:
        return self.n - 1

    def get_frame(self, idx: int) -> Frame:
        """Keyframe ``idx`` as a Frame over copies of its rows (one host read
        for its fusion counters and score); an evicted one's rows come from
        its host buffers."""
        with self._on_store_stream():
            slot = int(self.slot_of[idx])
            if slot >= 0:
                rows = tuple(getattr(self, name)[slot].clone() for name in _PAGED)
            else:
                h = self._host_rows[idx]
                rows = tuple(h[name].to(self.device) for name in _PAGED)
            X, C, feat, pos = rows
            feat, pos = feat[None], pos[None]
            T = self.T_WC[idx].clone()
            counters = torch.stack([self.n_fused[idx].float(), self.n_updates[idx].float(),
                                    self.score[idx].float()])
            frame_id, uimg = int(self.frame_id[idx]), self.uimgs[idx]
        self._hand_out(T, X, C, feat, pos, counters)
        n_fused, n_updates, score = to_host(counters)[0].tolist()
        return Frame(frame_id=frame_id, img=None, T_WC=T, X_canon=X, C=C,
                     n_fused=int(n_fused), n_updates=int(n_updates), score=score,
                     feat=feat, pos=pos, K=self.K, uimg=uimg)

    def get_feat(self, idx: int) -> KeyframeFeat:
        """Keyframe ``idx``'s encoder tokens, a copy of its row, for
        retrieval (which reads nothing else of a frame): no host read."""
        with self._on_store_stream():
            slot = int(self.slot_of[idx])
            feat = (self.feat[slot].clone() if slot >= 0
                    else self._host_rows[idx]["feat"].to(self.device))[None]
        self._hand_out(feat)
        return KeyframeFeat(feat)

    def pop_last(self):
        """Drop the last keyframe (a failed relocalisation) and free its slot.
        ``generation`` moves, so a backend solve from an earlier snapshot
        cannot write its poses back.  ``pm_version`` of the keyframe is kept:
        the next ``append`` bumps it again, so no cached gather of the popped
        keyframe is served."""
        with self.lock:
            self.n -= 1
            self.generation += 1
            self.frame_id[self.n] = -1
            self.uimgs[self.n] = None
            slot = int(self.slot_of[self.n])
            if slot >= 0:
                self.slot_of[self.n] = -1
                self._slot_owner[slot] = -1
                self._free_slots.add(slot)
            self._host_rows.pop(self.n, None)
            self.sticky.discard(self.n)

    def update_pose(self, idx: int, T_WC):
        with self._on_store_stream(T_WC):
            self.T_WC[idx] = T_WC.to(self.T_WC)

    def update_pointmap(self, idx: int, X, C, n_fused, n_updates, score):
        """The tracker's per-frame commit of the keyframe's fused state."""
        with self._on_store_stream(X, C, n_fused, n_updates, score):
            slot = self._slot(idx, "update_pointmap")
            self.pm_version[idx] += 1
            self._host_rows.pop(idx, None)
            self.X[slot] = X
            self.C[slot] = C
            self.n_fused[idx] = n_fused
            self.n_updates[idx] = n_updates
            self.score[idx] = score

    def snapshot(self) -> KeyframeSnapshot:
        """The store at one moment, safe to read while the tracker writes and
        evictions reuse slots (see ``KeyframeSnapshot``)."""
        with self._on_store_stream():
            n = self.n
            m = self.dcap if self.paging else n
            feat, pos = ((self.feat.clone(), self.pos.clone()) if self.paging
                         else (self.feat, self.pos))
            snap = KeyframeSnapshot(
                n=n, generation=self.generation, T_WC=self.T_WC[:n].clone(),
                X=self.X[:m].clone(), C=self.C[:m].clone(),
                n_fused=self.n_fused[:n].clone(), feat=feat, pos=pos,
                slot_of=self.slot_of[:n].copy(),
                host_rows=dict(self._host_rows) if self.paging else None)
        self._hand_out(snap.T_WC, snap.X, snap.C, snap.n_fused, snap.feat, snap.pos)
        return snap

    def write_back_poses(self, start: int, n_snapshot: int, generation: int,
                         T_new, src_offset: int = None) -> bool:
        """Install solved poses [start, n_snapshot) from a backend solve: rows
        [src_offset, src_offset + n_snapshot - start) of ``T_new``
        (``src_offset`` defaults to ``start``: a pose array aligned with the
        store; a windowed solve's compact array holds its free poses after
        its pinned ones).  Refused (False) when a ``pop_last`` since the
        snapshot changed what the slots hold; keyframes appended since keep
        their tracked poses.  ``T_new`` may lie on another device (a mesh's
        first shard, the model's card under ``engine.pipeline: 2``): the rows
        are copied to the store's."""
        if src_offset is None:
            src_offset = start
        with self._on_store_stream(T_new):
            if self.generation != generation or self.n < n_snapshot:
                return False
            self.T_WC[start:n_snapshot] = T_new[
                src_offset:src_offset + n_snapshot - start].to(self.T_WC)
            return True

    def pose(self, idx: int) -> torch.Tensor:
        """A copy of keyframe ``idx``'s pose."""
        with self._on_store_stream():
            T = self.T_WC[idx].clone()
        self._hand_out(T)
        return T

    def tokens(self, idx: int):
        """(feat[None], pos[None]) of keyframe ``idx``: views into its slot (a
        slot's tokens never change while it holds its keyframe), or copies of
        an evicted keyframe's host buffers."""
        with self._on_store_stream():
            slot = int(self.slot_of[idx])
            if slot >= 0:
                out = (self.feat[slot][None], self.pos[slot][None])
            else:
                h = self._host_rows[idx]
                out = (h["feat"].to(self.device)[None], h["pos"].to(self.device)[None])
        self._hand_out(*out)
        return out

    def slices(self, idx: int):
        """(X, C, n_fused, n_updates, score, T_WC, feat[None], pos[None]) at
        idx, for the tracker: views into the store (only the tracker writes a
        keyframe's fused state, and the newest keyframes are never evicted),
        the pose a copy (a backend write-back may move it)."""
        with self._on_store_stream():
            slot = self._slot(idx, "slices")
            out = (self.X[slot], self.C[slot], self.n_fused[idx], self.n_updates[idx],
                   self.score[idx], self.T_WC[idx].clone(), self.feat[slot][None],
                   self.pos[slot][None])
        self._hand_out(*out)
        return out

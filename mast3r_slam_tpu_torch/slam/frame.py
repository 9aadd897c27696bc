"""Frames, pointmap fusion and the keyframe store (port of ``slam/frame.py``).

``fuse_pointmap`` covers all six filtering modes.  ``Keyframes`` is the
fixed-capacity SoA store without paging: preallocated tensors on the
device, written IN PLACE (one slot per keyframe) rather than rebuilt the
functional way the JAX package does, which would copy the whole store on
every write.  Capacity doubles when it runs out.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Optional

import numpy as np
import torch

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
    n_fused = torch.as_tensor(n_fused, dtype=torch.int32, device=dev)
    n_updates = torch.as_tensor(n_updates, dtype=torch.int32, device=dev)
    if score is None:
        score = float("-inf")
    score = torch.as_tensor(score, dtype=torch.float32, device=dev)
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


class Keyframes:
    """Device-resident SoA keyframe store of ``capacity`` slots."""

    def __init__(self, capacity: int, num_pixels: int, num_patches: int,
                 feat_dim: int, device, dtype=torch.float32):
        self.capacity = capacity
        self.num_pixels = num_pixels
        self.device = torch.device(device)
        self.n = 0
        dev = self.device
        self.frame_id = np.full((capacity,), -1, dtype=np.int64)
        self.T_WC = sim3.identity((capacity,), dtype=dtype, device=dev)
        self.X = torch.zeros((capacity, num_pixels, 3), dtype=dtype, device=dev)
        self.C = torch.zeros((capacity, num_pixels, 1), dtype=dtype, device=dev)
        self.n_fused = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        self.n_updates = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        self.score = torch.full((capacity,), float("-inf"), dtype=dtype, device=dev)
        self.feat = torch.zeros((capacity, num_patches, feat_dim), dtype=dtype, device=dev)
        self.pos = torch.zeros((capacity, num_patches, 2), dtype=torch.int32, device=dev)
        self.K: Optional[torch.Tensor] = None
        self.uimgs = [None] * capacity

    def __len__(self):
        return self.n

    def append(self, frame: Frame) -> int:
        idx = self.n
        self._ensure_capacity(idx + 1)
        self.set_frame(idx, frame)
        self.n = idx + 1
        return idx

    def _ensure_capacity(self, needed: int):
        """Double the store (copying it) when ``needed`` slots do not fit."""
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        pad = new_cap - self.capacity

        def grow(a, fill=0):
            return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

        self.T_WC = torch.cat([self.T_WC, sim3.identity(
            (pad,), dtype=self.T_WC.dtype, device=self.device)])
        self.X = grow(self.X)
        self.C = grow(self.C)
        self.n_fused = grow(self.n_fused)
        self.n_updates = grow(self.n_updates)
        self.score = grow(self.score, float("-inf"))
        self.feat = grow(self.feat)
        self.pos = grow(self.pos)
        self.frame_id = np.concatenate([self.frame_id, np.full((pad,), -1, np.int64)])
        self.uimgs = self.uimgs + [None] * pad
        self.capacity = new_cap

    def set_frame(self, idx: int, frame: Frame):
        self.frame_id[idx] = frame.frame_id
        self.T_WC[idx] = frame.T_WC.to(self.T_WC)
        self.X[idx] = frame.X_canon.to(self.X)
        self.C[idx] = frame.C.to(self.C)
        self.n_fused[idx] = int(frame.n_fused)
        self.n_updates[idx] = int(frame.n_updates)
        self.score[idx] = float(frame.score)
        self.feat[idx] = frame.feat[0].to(self.feat)
        self.pos[idx] = frame.pos[0].to(self.pos)
        self.uimgs[idx] = frame.uimg

    def last_idx(self) -> int:
        return self.n - 1

    def update_pointmap(self, idx: int, X, C, n_fused, n_updates, score):
        """The tracker's per-frame commit of the keyframe's fused state."""
        self.X[idx] = X
        self.C[idx] = C
        self.n_fused[idx] = n_fused
        self.n_updates[idx] = n_updates
        self.score[idx] = score

    def slices(self, idx: int):
        """(X, C, n_fused, n_updates, score, T_WC, feat[None], pos[None]) at
        idx: views into the store, which ``update_pointmap`` overwrites."""
        return (self.X[idx], self.C[idx], self.n_fused[idx], self.n_updates[idx],
                self.score[idx], self.T_WC[idx], self.feat[idx][None],
                self.pos[idx][None])

"""Trajectory export + ATE evaluation (port of
``mast3r_slam_tpu/eval/trajectory.py``, numpy only, kept as the port's own
copy; no `evo` dependency).

Export: one TUM line per keyframe, the Sim(3) pose exported as SE(3) by
dropping the scale.  ATE RMSE is computed with Umeyama Sim(3) alignment,
the metric of `evo_ape tum <gt> <traj> -as` (scripts/eval_tum.sh).
"""

from __future__ import annotations

import pathlib
from typing import List, Optional

import numpy as np


def save_traj_tum(path, timestamps: List[str], poses_se3: np.ndarray):
    """poses_se3: (K, 7) [x y z qx qy qz qw] rows, timestamps len K."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for t, p in zip(timestamps, poses_se3):
            x, y, z, qx, qy, qz, qw = [float(v) for v in p]
            f.write(f"{t} {x} {y} {z} {qx} {qy} {qz} {qw}\n")


def load_traj_tum(path):
    """Returns (timestamps (K,), positions (K, 3), quats (K, 4))."""
    rows = np.loadtxt(path, comments="#")
    if rows.ndim == 1:
        rows = rows[None]
    return rows[:, 0], rows[:, 1:4], rows[:, 4:8]


def associate(t_a, t_b, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (TUM tooling semantics)."""
    ia, ib = [], []
    j = 0
    order = np.argsort(t_b)
    t_b_sorted = t_b[order]
    for i, t in enumerate(t_a):
        j = np.searchsorted(t_b_sorted, t)
        best, bestd = None, max_dt
        for cand in (j - 1, j):
            if 0 <= cand < len(t_b_sorted):
                d = abs(t_b_sorted[cand] - t)
                if d <= bestd:
                    best, bestd = cand, d
        if best is not None:
            ia.append(i)
            ib.append(order[best])
    return np.asarray(ia, dtype=int), np.asarray(ib, dtype=int)


def umeyama_alignment(x, y, with_scale: bool = True):
    """Least-squares similarity aligning x -> y; x, y: (N, 3).

    Returns (s, R, t) with y ≈ s R x + t.
    """
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / len(x)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc**2).sum() / len(x)
    s = np.trace(np.diag(d) @ S) / var_x if with_scale else 1.0
    t = mu_y - s * R @ mu_x
    return s, R, t


def ate_rmse(
    est_path,
    gt_path,
    max_dt: float = 0.02,
    with_scale: bool = True,
) -> Optional[float]:
    """Sim(3)-aligned absolute trajectory error RMSE in meters.

    Matches `evo_ape tum <gt> <est> -as` (align + correct_scale).
    Returns None if fewer than 3 associations.
    """
    t_e, p_e, _ = load_traj_tum(est_path)
    t_g, p_g, _ = load_traj_tum(gt_path)
    ie, ig = associate(t_e, t_g, max_dt)
    if len(ie) < 3:
        return None
    x = p_e[ie]
    y = p_g[ig]
    s, R, t = umeyama_alignment(x, y, with_scale)
    aligned = (s * (R @ x.T)).T + t
    err = np.linalg.norm(aligned - y, axis=-1)
    return float(np.sqrt(np.mean(err**2)))

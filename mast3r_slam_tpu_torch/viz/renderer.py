"""Headless map views (port of ``mast3r_slam_tpu/viz/renderer.py``).

``export_scene_json`` writes the trajectory, frames and graph edges for
the JAX package's web viewer (``mast3r_slam_tpu/viz/viewer.html``);
``frustum_points`` sketches a camera.  ``render_topdown`` draws the same
selection as the JAX package's matplotlib figure (points over the
confidence threshold, at most ``max_points`` of them drawn by
``default_rng(0)``, the two chosen world axes, the keyframe path and the
graph edges) with a numpy rasteriser into a PNG, because the card's
machine has no matplotlib: the picture is not pixel-equal to the JAX
figure (no axes, ticks or legend; one pixel a point).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..data.png import write_png
from ..eval.export import world_points
from ..lie import sim3

TRAJ_RGB = np.array([217, 119, 6], np.float64)    # #d97706, the keyframe path
EDGE_RGB = np.array([37, 99, 235], np.float64)    # #2563eb, graph edges
EDGE_ALPHA = 0.5
CANVAS = 1100    # pixels a side (the JAX figure: 10 in at 110 dpi)
MARGIN = 40


def frustum_points(T_WC, scale=0.1):
    """8 line segments sketching a camera frustum in world coords."""
    c = np.array([[0, 0, 0], [-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5],
                  [-1, 0.75, 1.5]]) * scale
    T = torch.as_tensor(np.asarray(T_WC, np.float32))
    cw = sim3.act(T[None], torch.as_tensor(c, dtype=torch.float32)).numpy()
    segs = [(cw[0], cw[i]) for i in range(1, 5)]
    segs += [(cw[i], cw[i % 4 + 1]) for i in range(1, 5)]
    return segs


def _segment_pixels(p0, p1):
    """Integer pixels of the segment p0 -> p1 (one a step of the longer axis)."""
    n = int(np.ceil(np.abs(p1 - p0).max())) + 1
    s = np.linspace(0.0, 1.0, n)[:, None]
    return np.rint(p0 + s * (p1 - p0)).astype(np.int64)


def topdown_points(keyframes, conf_threshold: float = 1.5, max_points: int = 200_000):
    """The points ``render_topdown`` draws: every keyframe's world points over
    ``conf_threshold`` with their colours in [0, 1] (0.5 gray without an
    image of the pointmap's size), at most ``max_points`` of them drawn by
    ``default_rng(0)``.  (P (M, 3), C (M, 3)), or None without keyframes."""
    pts, cols = [], []
    for i in range(len(keyframes)):
        pW, conf = world_points(keyframes, i, None)
        sel = conf > conf_threshold
        uimg = keyframes.uimgs[i]
        if uimg is not None and np.asarray(uimg).reshape(-1, 3).shape[0] == len(pW):
            col = np.asarray(uimg).reshape(-1, 3)
            if col.dtype == np.uint8:
                col = col / 255.0
            col = col[sel]
        else:
            col = np.full((int(sel.sum()), 3), 0.5)
        pts.append(pW[sel])
        cols.append(col)
    if not pts:
        return None
    P = np.concatenate(pts)
    C = np.concatenate(cols)
    if len(P) > max_points:
        sel = np.random.default_rng(0).choice(len(P), max_points, replace=False)
        P, C = P[sel], C[sel]
    return P, C


def render_topdown(keyframes, out_path, conf_threshold: float = 1.5, axes=(0, 2),
                   max_points: int = 200_000, edges=None):
    """Top-down view of the world pointcloud, keyframe path and graph edges
    -> an RGB PNG of CANVAS x CANVAS pixels."""
    sel = topdown_points(keyframes, conf_threshold, max_points)
    if sel is None:
        return
    P, C = sel
    n = len(keyframes)
    a, b = axes
    drawable = np.isfinite(P[:, [a, b]]).all(axis=1)
    P, C = P[drawable], C[drawable]
    with keyframes.lock:
        traj = keyframes.T_WC[:n, :3].cpu().numpy().astype(np.float64)
    xy = np.concatenate([P[:, [a, b]], traj[:, [a, b]]]).astype(np.float64)
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    span = max(float((hi - lo).max()), 1e-9)
    px = (CANVAS - 2 * MARGIN - 1) / span
    center = (lo + hi) / 2

    def to_pixels(v):  # world (a, b) -> (column, row); b grows upward
        u = (v - center) * px
        return np.stack([CANVAS / 2 + u[:, 0], CANVAS / 2 - u[:, 1]], axis=-1)

    img = np.full((CANVAS, CANVAS, 3), 255.0)
    p = np.rint(to_pixels(P[:, [a, b]].astype(np.float64))).astype(np.int64)
    img[p[:, 1], p[:, 0]] = np.clip(C, 0, 1) * 255.0
    t = to_pixels(traj[:, [a, b]])
    for k in range(n - 1):
        q = _segment_pixels(t[k], t[k + 1])
        img[q[:, 1], q[:, 0]] = TRAJ_RGB
    for cx, cy in np.rint(t).astype(np.int64):  # a 5x5 dot a keyframe
        img[max(cy - 2, 0):cy + 3, max(cx - 2, 0):cx + 3] = TRAJ_RGB
    for i, j in (edges or []):
        q = _segment_pixels(t[i], t[j])
        img[q[:, 1], q[:, 0]] = (1 - EDGE_ALPHA) * img[q[:, 1], q[:, 0]] + EDGE_ALPHA * EDGE_RGB
    write_png(out_path, np.rint(img).astype(np.uint8))


def export_scene_json(slam, out_path):
    """Trajectory + frame ids + graph edges + mode, for the web viewer."""
    kf = slam.keyframes
    n = len(kf)
    g = slam.graph
    with kf.lock:
        poses = kf.T_WC[:n].cpu().numpy()
    data = {
        "keyframe_poses": poses.tolist(),
        "frame_ids": [int(x) for x in kf.frame_id[:n]],
        "edges": [[int(g.ii[e]), int(g.jj[e])] for e in range(g.n_edges)],
        "mode": slam.mode.name,
    }
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(data))

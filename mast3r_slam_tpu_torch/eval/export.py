"""Map export: PLY pointclouds and keyframe images (port of
``mast3r_slam_tpu/eval/export.py``).

The PLY is binary little-endian, written directly; keyframe images go
through ``data/png.py``.  The keyframe store is read on its device, under
its lock, one keyframe at a time.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..data.png import write_png
from ..geometry import constrain_points_to_ray
from ..lie import sim3

_PLY_VERTEX = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")]


def save_ply(filename, points: np.ndarray, colors: np.ndarray):
    """points (N, 3) f32, colors (N, 3) uint8 -> binary PLY."""
    filename = pathlib.Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    n = len(points)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=_PLY_VERTEX)
    rec["x"], rec["y"], rec["z"] = points.astype(np.float32).T
    rec["red"], rec["green"], rec["blue"] = colors.astype(np.uint8).T
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def load_ply(filename):
    """Read back a PLY written by :func:`save_ply` -> (points, colors)."""
    data = pathlib.Path(filename).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii")
    n = int([l for l in header.splitlines() if l.startswith("element vertex")][0].split()[-1])
    rec = np.frombuffer(data[end:], dtype=_PLY_VERTEX, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1)
    col = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
    return pts, col


def _uint8(img) -> np.ndarray:
    img = np.asarray(img)
    return img if img.dtype == np.uint8 else (img * 255).astype(np.uint8)


@torch.no_grad()
def world_points(keyframes, i: int, img_hw, use_calib: bool = False):
    """Keyframe i's pointmap in the world frame and its per-pixel confidence
    (C over the fused count), both as (N, ...) numpy; calibrated runs snap
    the points onto the pixel rays first."""
    with keyframes.lock:
        X, C = keyframes.X[i], keyframes.C[i]
        n_fused = keyframes.n_fused[i].float().clamp_min(1.0)
        if use_calib and keyframes.K is not None:
            X = constrain_points_to_ray(img_hw, X, keyframes.K)
        pW = sim3.act(keyframes.T_WC[i][None], X)
        conf = C.reshape(-1) / n_fused
    return pW.reshape(-1, 3).cpu().numpy(), conf.cpu().numpy()


def save_reconstruction(filename, keyframes, img_hw, conf_threshold: float,
                        use_calib: bool = False):
    """Confidence-thresholded world pointcloud of every keyframe -> PLY."""
    pointclouds, colors = [], []
    for i in range(len(keyframes)):
        pW, conf = world_points(keyframes, i, img_hw, use_calib)
        uimg = keyframes.uimgs[i]
        if uimg is None or np.asarray(uimg).reshape(-1, 3).shape[0] != pW.shape[0]:
            # no image, or one at another resolution than the pointmap
            color = np.full((pW.shape[0], 3), 128, dtype=np.uint8)
        else:
            color = _uint8(uimg).reshape(-1, 3)
        valid = conf > conf_threshold
        pointclouds.append(pW[valid])
        colors.append(color[valid])
    save_ply(filename, np.concatenate(pointclouds, axis=0), np.concatenate(colors, axis=0))


def save_keyframes(savedir, timestamps, keyframes):
    """Each keyframe's RGB image as <savedir>/<timestamp>.png."""
    savedir = pathlib.Path(savedir)
    savedir.mkdir(parents=True, exist_ok=True)
    for i in range(len(keyframes)):
        uimg = keyframes.uimgs[i]
        if uimg is None:
            continue
        t = timestamps[int(keyframes.frame_id[i])]
        write_png(savedir / f"{t}.png", _uint8(uimg))

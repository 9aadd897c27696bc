"""Projective geometry with analytic Jacobians.

Port of ``mast3r_slam_tpu/geometry/projective.py``: every function is
batched over pixels; the Jacobian variants return stacked (..., rows, cols)
tensors for the Gauss-Newton assembly.
"""

from __future__ import annotations

import torch

from ..lie import sim3
from ..utils.numerics import vnorm


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def point_to_dist(X):
    return vnorm(X)


def tau_jacobian(dres_dY, Y):
    """d(res)/d(tau) through a left Sim(3) perturbation: rows [a | Y x a | a.Y].

    dres_dY: (..., R, 3); Y: (..., 3).  Returns (..., R, 7).
    """
    Yb = Y[..., None, :].expand_as(dres_dY)
    rot = torch.linalg.cross(Yb, dres_dY, dim=-1)
    scale = torch.sum(dres_dY * Yb, dim=-1, keepdim=True)
    return torch.cat([dres_dY, rot, scale], dim=-1)


def point_to_ray_dist(X, jacobian: bool = False):
    """(..., 3) -> (..., 4) [unit ray, distance]; optionally d(rd)/dX (..., 4, 3)."""
    d = point_to_dist(X)
    d_inv = 1.0 / d
    r = d_inv * X
    rd = torch.cat([r, d], dim=-1)
    if not jacobian:
        return rd
    d_inv_2 = d_inv * d_inv
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[:-1] + (3, 3))
    outer = X[..., :, None] * X[..., None, :]
    dr_dX = d_inv[..., None] * (eye - d_inv_2[..., None] * outer)
    dd_dX = r[..., None, :]
    return rd, torch.cat([dr_dX, dd_dX], dim=-2)


def act_sim3(T, X, jacobian: bool = False):
    """Transform points and optionally d(TX)/d(tau) (..., 3, 7): [I, -[TX]x, TX]."""
    Y = sim3.act(T, X)
    if not jacobian:
        return Y
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Y.shape[:-1] + (3, 3))
    J = torch.cat([eye, -skew(Y), Y[..., :, None]], dim=-1)
    return Y, J


def decompose_K(K):
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def project_calib(P, K, img_size, jacobian: bool = False, border: float = 0.0,
                  z_eps: float = 0.0):
    """Pinhole projection to (u, v, log z) with a validity mask.

    Returns pz (..., 3), [dpz_dP (..., 3, 3)], valid (..., 1) bool.
    """
    H, W = img_size
    fx, fy, cx, cy = decompose_K(K)
    x = P[..., 0]
    y = P[..., 1]
    z = P[..., 2]
    valid_z = z > z_eps
    z_safe = torch.where(valid_z, z, torch.ones_like(z))
    z_inv = 1.0 / z_safe
    u = fx * x * z_inv + cx
    v = fy * y * z_inv + cy

    valid_u = (u > border) & (u < W - 1 - border)
    valid_v = (v > border) & (v < H - 1 - border)
    valid = (valid_u & valid_v & valid_z)[..., None]

    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z_safe))
    pz = torch.stack([u, v, logz], dim=-1)
    if not jacobian:
        return pz, valid

    zero = torch.zeros_like(z_inv)
    row_u = torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv], dim=-1)
    row_v = torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1)
    row_z = torch.stack([zero, zero, z_inv], dim=-1)
    dpz_dP = torch.stack([row_u, row_v, row_z], dim=-2)
    return pz, dpz_dP, valid


def backproject(p, z, K):
    """Pixels (..., 2) + depth (..., 1) -> camera points (..., 3)."""
    x = (p[..., 0] - K[0, 2]) / K[0, 0]
    y = (p[..., 1] - K[1, 2]) / K[1, 1]
    dirs = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return z * dirs


def get_pixel_coords(img_size, dtype=torch.float32, device=None):
    """(H, W) -> (H, W, 2) of (u, v) pixel coordinates."""
    H, W = img_size
    u = torch.arange(W, dtype=dtype, device=device)
    v = torch.arange(H, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def constrain_points_to_ray(img_size, Xs, K):
    """Snap an (H*W, 3) pointmap onto the calibrated pixel rays, keeping z."""
    uv = get_pixel_coords(img_size, dtype=Xs.dtype, device=Xs.device).reshape(-1, 2)
    uv = uv.expand(Xs.shape[:-1] + (2,))
    return backproject(uv, Xs[..., 2:3], K)

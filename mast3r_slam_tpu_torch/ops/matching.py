"""Dense iterative projective matching (port of ``mast3r_slam_tpu/ops/matching.py``).

The reference-exact path: ``prep_for_iter_proj`` builds the 9-channel ray
image; ``iter_proj`` runs the per-pixel 2-DoF Levenberg-Marquardt ray
alignment on every pixel for every iteration, with warm init and the X11
channel riding the same gather for the occlusion check; ``refine_matches``
runs the coarse-to-fine descriptor argmax through ``ops.refine`` (one CUDA
kernel launch per call on the card).  ``iter_proj`` stays plain torch.
The speed-profile paths (gated refinement, gated LM, pinhole init) are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from ..utils.image import img_gradient_nhwc
from ..utils.numerics import vnorm, vnormalize
from .refine import quantize, refine_window

_SPEED_PATHS = ("the speed-profile matching paths (ROADMAP Queue 1, item 4: "
                "pinhole_init, proj_gate, refine_matches_gated)")


# ---------------------------------------------------------------------------
# iter_proj
# ---------------------------------------------------------------------------

def _pack_bilinear_table(img, extra=None):
    """(B, H, W, C) -> (B, H*W, 4C [+E]) rows [TL, TR, BL, BR [, extra]];
    ``extra`` rides along at the row's own pixel, not interpolated."""
    B, H, W, C = img.shape
    p = torch.cat([img, img[:, -1:]], dim=1)        # edge pad bottom
    p = torch.cat([p, p[:, :, -1:]], dim=2)         # edge pad right
    parts = [p[:, :H, :W], p[:, :H, 1:W + 1], p[:, 1:H + 1, :W], p[:, 1:H + 1, 1:W + 1]]
    if extra is not None:
        parts.append(extra)
    packed = torch.cat(parts, dim=-1)
    return packed.reshape(B, H * W, packed.shape[-1])


def _sample_packed(table, W: int, u, v, C: int):
    """Bilinear sample of the packed table at float (u, v) (B, N).
    Returns ((B, N, C) sample, (B, N, E) TL-extra)."""
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    du = (u - u0f)[..., None]
    dv = (v - v0f)[..., None]
    idx = v0f.to(torch.int64) * W + u0f.to(torch.int64)
    rows = torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))
    tl = rows[..., 0:C]
    tr = rows[..., C:2 * C]
    bl = rows[..., 2 * C:3 * C]
    br = rows[..., 3 * C:4 * C]
    smp = ((1 - du) * (1 - dv) * tl + du * (1 - dv) * tr
           + (1 - du) * dv * bl + du * dv * br)
    return smp, rows[..., 4 * C:]


def _ray_err(sample, target):
    r = vnormalize(sample[..., 0:3])
    err = r - target
    cost = torch.sum(err * err, dim=-1)
    return err, cost, sample[..., 3:6], sample[..., 6:9]


def _lm_step(table, W: int, H: int, target, cost_thresh: float, state):
    """One lock-step LM iteration over all (B, N) pixels (the CUDA loop
    body, matching_kernels.cu:152-266); the accepted trial sample is
    carried, so each iteration costs one gather."""
    u, v, lam, conv, err, cost, gx, gy, xtl = state
    A00 = torch.sum(gx * gx, dim=-1) + lam
    A01 = torch.sum(gx * gy, dim=-1)
    A11 = torch.sum(gy * gy, dim=-1) + lam
    b0 = -torch.sum(err * gx, dim=-1)
    b1 = -torch.sum(err * gy, dim=-1)

    det = A00 * A11 - A01 * A01
    det_inv = torch.where(det == 0, torch.zeros_like(det), 1.0 / det)
    du = det_inv * (A11 * b0 - A01 * b1)
    dv = det_inv * (-A01 * b0 + A00 * b1)

    u_new = torch.clamp(u + du, 1.0, W - 2.0)
    v_new = torch.clamp(v + dv, 1.0, H - 2.0)

    smp, n_xtl = _sample_packed(table, W, u_new, v_new, 9)
    n_err, n_cost, n_gx, n_gy = _ray_err(smp, target)

    accept = n_cost < cost
    acc1 = accept[..., None]
    u = torch.where(accept, u_new, u)
    v = torch.where(accept, v_new, v)
    lam = torch.where(accept, lam * 0.1, lam * 10.0)
    conv = torch.where(accept, n_cost < cost_thresh, cost < cost_thresh)
    err = torch.where(acc1, n_err, err)
    gx = torch.where(acc1, n_gx, gx)
    gy = torch.where(acc1, n_gy, gy)
    cost = torch.where(accept, n_cost, cost)
    xtl = torch.where(acc1, n_xtl, xtl)
    return u, v, lam, conv, err, cost, gx, gy, xtl


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter: int = 10,
              lambda_init: float = 1e-8, cost_thresh: float = 1e-6,
              extra_img=None):
    """Per-pixel LM projective association, every pixel for every iteration.

    rays_with_grad_img: (B, H, W, 9) [unit ray, d/dx, d/dy]
    pts3d_norm: (B, N, 3) unit target rays; p_init: (B, N, 2) start (u, v)
    extra_img: optional (B, H, W, E) read at the final integer pixel.
    Returns (p (B, N, 2) f32, converged (B, N) bool, extra_at (B, N, E)).
    """
    _, H, W, _ = rays_with_grad_img.shape
    rays_with_grad_img = rays_with_grad_img.float()
    pts3d_norm = pts3d_norm.float()
    p_init = p_init.float()
    table = _pack_bilinear_table(rays_with_grad_img, extra_img)

    u = torch.clamp(p_init[..., 0], 1.0, W - 2.0)
    v = torch.clamp(p_init[..., 1], 1.0, H - 2.0)
    lam = torch.full_like(u, lambda_init)
    smp, xtl = _sample_packed(table, W, u, v, 9)
    err, cost, gx, gy = _ray_err(smp, pts3d_norm)
    conv = cost < cost_thresh

    state = (u, v, lam, conv, err, cost, gx, gy, xtl)
    for _ in range(max_iter):
        state = _lm_step(table, W, H, pts3d_norm, cost_thresh, state)
    u, v, _, conv, *_, xtl = state
    return torch.stack([u, v], dim=-1), conv, xtl


# ---------------------------------------------------------------------------
# refine_matches
# ---------------------------------------------------------------------------

def refine_matches(D11, D21, p1, radius: int = 3, dilation_max: int = 5):
    """Coarse-to-fine descriptor argmax around integer pixels.

    D11: (B, H, W, F); D21: (B, N, F); p1: (B, N, 2) integer (u, v).
    Returns refined (B, N, 2) int32 positions.
    """
    B, H, W, F = D11.shape
    D11q = quantize(D11).reshape(B, H * W, F).contiguous()
    D21q = quantize(D21).contiguous()
    p1 = p1.to(torch.int32)
    idx = (p1[..., 0] + W * p1[..., 1]).contiguous()
    out = refine_window(D11q, D21q, idx, H, W, radius, dilation_max)
    return lin_to_pixel(out, W)


# ---------------------------------------------------------------------------
# orchestration (reference matching.py)
# ---------------------------------------------------------------------------

def pixel_to_lin(p, w: int):
    return p[..., 0] + w * p[..., 1]


def lin_to_pixel(idx, w: int):
    return torch.stack([idx % w, torch.div(idx, w, rounding_mode="floor")], dim=-1)


def prep_for_iter_proj(X11, X21, idx_1_to_2_init):
    """9-channel ray image, unit target rays and initial pixels."""
    B, H, W, _ = X11.shape
    rays = vnormalize(X11)
    gx, gy = img_gradient_nhwc(rays)
    rays_with_grad = torch.cat([rays, gx, gy], dim=-1)
    X21_vec = X21.reshape(B, -1, 3)
    pts3d_norm = vnormalize(X21_vec)
    if idx_1_to_2_init is None:
        if X21_vec.shape[1] != H * W:
            raise ValueError("a subset source needs an explicit idx_1_to_2_init")
        idx_1_to_2_init = torch.arange(H * W, dtype=torch.int32,
                                       device=X11.device).expand(B, H * W)
    p_init = lin_to_pixel(idx_1_to_2_init, W).to(X11.dtype)
    return rays_with_grad, pts3d_norm, p_init


def match(X11, X21, D11, D21, idx_1_to_2_init=None, *, max_iter: int = 10,
          lambda_init: float = 1e-8, convergence_thresh: float = 1e-6,
          dist_thresh: float = 1e-1, radius: int = 3, dilation_max: int = 5,
          refine_gate: str = "none", proj_gate: str = "none",
          proj_init: str = "warm"):
    """Dense 1->2 association (reference matching.py:8-90).

    X11, X21: (B, H, W, 3); D11, D21: (B, H, W, F).
    Returns (idx_1_to_2 (B, N) int32, valid (B, N, 1) bool).
    """
    if refine_gate != "none" or proj_gate != "none" or proj_init != "warm":
        raise NotImplementedError(
            f"refine_gate={refine_gate!r}, proj_gate={proj_gate!r}, "
            f"proj_init={proj_init!r}: {_SPEED_PATHS} are not ported yet")
    B, H, W, _ = X11.shape
    rays_with_grad, pts3d_norm, p_init = prep_for_iter_proj(X11, X21, idx_1_to_2_init)
    p1, valid_proj, X11_at = iter_proj(
        rays_with_grad, pts3d_norm, p_init, max_iter=max_iter,
        lambda_init=lambda_init, cost_thresh=convergence_thresh, extra_img=X11)
    p1 = p1.to(torch.int32)

    dists = vnorm(X11_at - X21.reshape(B, -1, 3), keepdim=False)
    valid = valid_proj & (dists < dist_thresh)

    if radius > 0:
        D21_flat = D21.reshape(B, pts3d_norm.shape[1], -1)
        p1 = refine_matches(D11, D21_flat, p1, radius=radius, dilation_max=dilation_max)

    idx_1_to_2 = pixel_to_lin(p1, W).to(torch.int32)
    return idx_1_to_2, valid[..., None]

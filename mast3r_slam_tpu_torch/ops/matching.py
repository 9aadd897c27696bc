"""Dense iterative projective matching (port of ``mast3r_slam_tpu/ops/matching.py``).

``prep_for_iter_proj`` builds the 9-channel ray image; ``iter_proj`` runs
the per-pixel 2-DoF Levenberg-Marquardt ray alignment, with warm init and
the X11 channel riding the same gather for the occlusion check;
``refine_matches`` runs the coarse-to-fine descriptor argmax through
``ops.refine`` (one CUDA kernel launch per call on the card).

The speed profile's paths: ``pinhole_init`` starts the LM from a pinhole
fitted to the ray image (``proj_init: pinhole | best``); ``iter_proj``'s
``gate="converged"`` runs the iterations after ``pre_iters`` on a compacted
subset of unconverged pixels (``_compact_unconverged``); and
``refine_matches_gated`` runs the coarse levels on such a subset and a
finest level on every pixel: two launches of the refine kernel, each with
its own dilation schedule.  The LM and the compaction stay plain torch (the
JAX package has no Pallas kernel for them).
"""

from __future__ import annotations

import torch

from ..utils.image import img_gradient_nhwc
from ..utils.numerics import vnorm, vnormalize
from .refine import quantize, refine_window, schedule

GATES = ("none", "converged")
PROJ_INITS = ("warm", "pinhole", "best")


MATCH_KEYS = ("max_iter", "lambda_init", "convergence_thresh", "dist_thresh", "radius",
              "dilation_max", "refine_gate", "refine_budget_frac",
              "refine_subset_dilations", "refine_final_radius", "proj_gate",
              "proj_init", "proj_pre_iters", "proj_budget_frac")


def match_kwargs(cfg) -> dict:
    """The keyword arguments of ``match`` from a config's ``matching``
    section, with the JAX package's defaults for the speed keys."""
    m = cfg["matching"]
    sub = m.get("refine_subset_dilations")
    return dict(
        max_iter=m["max_iter"],
        lambda_init=m["lambda_init"],
        convergence_thresh=m["convergence_thresh"],
        dist_thresh=m["dist_thresh"],
        radius=m["radius"],
        dilation_max=m["dilation_max"],
        refine_gate=m.get("refine_gate", "none"),
        refine_budget_frac=m.get("refine_budget_frac", 0.125),
        refine_subset_dilations=tuple(sub) if sub else None,
        refine_final_radius=m.get("refine_final_radius"),
        proj_gate=m.get("proj_gate", "none"),
        proj_init=m.get("proj_init", "warm"),
        proj_pre_iters=m.get("proj_pre_iters", 2),
        proj_budget_frac=m.get("proj_budget_frac", 0.125),
    )


def gate_budget(N: int, budget_frac: float) -> int:
    """Pixels a gated stage takes: ``budget_frac`` of N in whole 128s, at
    least 128 (the JAX package's static subset size)."""
    return max(int(N * budget_frac) // 128 * 128, 128)


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


def fit_pinhole_from_rays(rays, eps: float = 1e-6):
    """Closed-form least-squares pinhole fit to a unit-ray image (B, H, W, 3):
    ``u = fx * rx / rz + cx`` and ``v = fy * ry / rz + cy`` over the pixels
    with rz > eps.  Returns (fx, fy, cx, cy), each (B,)."""
    B, H, W, _ = rays.shape
    dt, dev = rays.dtype, rays.device
    rz = rays[..., 2]
    valid = (rz > eps).to(dt)
    safe_z = torch.where(rz > eps, rz, torch.ones_like(rz))
    x = (rays[..., 0] / safe_z) * valid
    y = (rays[..., 1] / safe_z) * valid
    u = torch.arange(W, dtype=dt, device=dev)[None, None, :].expand(B, H, W)
    v = torch.arange(H, dtype=dt, device=dev)[None, :, None].expand(B, H, W)
    n = torch.clamp_min(valid.sum(dim=(1, 2)), 1.0)

    def fit(a, b):
        am = (a.sum(dim=(1, 2)) / n)[:, None, None]
        bm = ((b * valid).sum(dim=(1, 2)) / n)[:, None, None]
        cov = ((a - am) * (b - bm) * valid).sum(dim=(1, 2))
        var = ((a - am) ** 2 * valid).sum(dim=(1, 2))
        slope = cov / torch.clamp_min(var, eps)
        return slope, bm[:, 0, 0] - slope * am[:, 0, 0]

    fx, cx = fit(x, u)
    fy, cy = fit(y, v)
    return fx, fy, cx, cy


def pinhole_init(rays_img, pts3d_norm):
    """Project target rays (B, N, 3) through a pinhole fitted to the ray
    image (B, H, W, >=3).  Returns (B, N, 2) start pixels."""
    fx, fy, cx, cy = fit_pinhole_from_rays(rays_img[..., :3])
    tz = torch.clamp_min(pts3d_norm[..., 2], 1e-6)
    u = fx[:, None] * pts3d_norm[..., 0] / tz + cx[:, None]
    v = fy[:, None] * pts3d_norm[..., 1] / tz + cy[:, None]
    return torch.stack([u, v], dim=-1)


def _compact_unconverged(conv, budget: int):
    """(B, budget) int64 indices: every unconverged pixel first, in index
    order, then converged low-index pixels as filler (slot k holds k unless
    an unconverged pixel took it).  One cumsum and one scatter; unconverged
    pixels beyond the budget go to a dump column that is cut off (the JAX
    package's scatter drops them).  Filler may repeat an index that also
    sits in another slot: both copies iterate identically, so a scatter
    back writes equal values."""
    B, N = conv.shape
    unconv = ~conv
    rank = torch.cumsum(unconv.to(torch.int64), dim=1) - 1
    pos = torch.where(unconv, torch.clamp_max(rank, budget), torch.full_like(rank, budget))
    out = torch.arange(budget + 1, device=conv.device).expand(B, budget + 1).clone()
    out.scatter_(1, pos, torch.arange(N, device=conv.device).expand(B, N))
    return out[:, :budget]


def _take(a, sel):
    """a (B, N[, C]) at the (B, S) indices sel, along N."""
    if a.ndim == 2:
        return torch.gather(a, 1, sel)
    return torch.gather(a, 1, sel[..., None].expand(-1, -1, a.shape[-1]))


def _put(a, sel, val):
    """a with rows sel (B, S) along N set to val (repeated indices carry
    equal values, so which copy lands does not matter)."""
    if a.ndim == 2:
        return a.scatter(1, sel, val)
    return a.scatter(1, sel[..., None].expand(-1, -1, a.shape[-1]), val)


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter: int = 10,
              lambda_init: float = 1e-8, cost_thresh: float = 1e-6,
              gate: str = "none", pre_iters: int = 2, budget_frac: float = 0.125,
              p_init_alt=None, extra_img=None):
    """Per-pixel LM projective association.

    rays_with_grad_img: (B, H, W, 9) [unit ray, d/dx, d/dy]
    pts3d_norm: (B, N, 3) unit target rays; p_init: (B, N, 2) start (u, v)
    gate: "none" runs every pixel for every iteration; "converged" runs
    ``pre_iters`` lock-step iterations, then the rest on a compacted subset
    of ``gate_budget(N, budget_frac)`` pixels, unconverged first; pixels
    left outside keep their state (the JAX package's semantics).
    p_init_alt: optional second (B, N, 2) start; each pixel starts from the
    lower-cost of the two.
    extra_img: optional (B, H, W, E) read at the final integer pixel.
    Returns (p (B, N, 2) f32, converged (B, N) bool, extra_at (B, N, E)).
    """
    if gate not in GATES:
        raise ValueError(f"iter_proj: gate {gate!r}, expected one of {GATES}")
    _, H, W, _ = rays_with_grad_img.shape
    N = pts3d_norm.shape[1]
    rays_with_grad_img = rays_with_grad_img.float()
    pts3d_norm = pts3d_norm.float()
    p_init = p_init.float()
    table = _pack_bilinear_table(rays_with_grad_img, extra_img)

    u = torch.clamp(p_init[..., 0], 1.0, W - 2.0)
    v = torch.clamp(p_init[..., 1], 1.0, H - 2.0)
    lam = torch.full_like(u, lambda_init)
    smp, xtl = _sample_packed(table, W, u, v, 9)
    err, cost, gx, gy = _ray_err(smp, pts3d_norm)

    if p_init_alt is not None:
        u2 = torch.clamp(p_init_alt[..., 0].float(), 1.0, W - 2.0)
        v2 = torch.clamp(p_init_alt[..., 1].float(), 1.0, H - 2.0)
        smp2, xtl2 = _sample_packed(table, W, u2, v2, 9)
        err2, cost2, gx2, gy2 = _ray_err(smp2, pts3d_norm)
        better = cost2 < cost
        b1 = better[..., None]
        u = torch.where(better, u2, u)
        v = torch.where(better, v2, v)
        err = torch.where(b1, err2, err)
        cost = torch.where(better, cost2, cost)
        gx = torch.where(b1, gx2, gx)
        gy = torch.where(b1, gy2, gy)
        xtl = torch.where(b1, xtl2, xtl)

    # seeded from the start cost: each iteration recomputes it, so this only
    # lets the gate compact well-started pixels out early
    conv = cost < cost_thresh
    state = (u, v, lam, conv, err, cost, gx, gy, xtl)
    budget = gate_budget(N, budget_frac)
    if gate == "none" or pre_iters >= max_iter or budget >= N:
        for _ in range(max_iter):
            state = _lm_step(table, W, H, pts3d_norm, cost_thresh, state)
        u, v, _, conv, *_, xtl = state
        return torch.stack([u, v], dim=-1), conv, xtl

    for _ in range(pre_iters):
        state = _lm_step(table, W, H, pts3d_norm, cost_thresh, state)
    u, v, lam, conv, err, cost, gx, gy, xtl = state
    sel = _compact_unconverged(conv, budget)
    sub = tuple(_take(a, sel) for a in state)
    tgt_sub = _take(pts3d_norm, sel)
    for _ in range(max_iter - pre_iters):
        sub = _lm_step(table, W, H, tgt_sub, cost_thresh, sub)
    u = _put(u, sel, sub[0])
    v = _put(v, sel, sub[1])
    conv = _put(conv, sel, sub[3])
    xtl = _put(xtl, sel, sub[8])
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
    out = refine_window(D11q, D21q, idx, H, W, radius, schedule(dilation_max))
    return lin_to_pixel(out, W)


def refine_matches_gated(D11, D21, p1, converged, radius: int = 3,
                         dilation_max: int = 5, budget_frac: float = 0.25,
                         subset_dilations=None, final_radius: int = None):
    """Convergence-gated coarse-to-fine refinement (the speed profile).

    The coarse levels (``subset_dilations``, default dilation_max .. 2) run
    on a compacted subset of ``gate_budget(N, budget_frac)`` pixels,
    unconverged first, at ``radius``; then a finest level (dilation 1) on
    every pixel at ``final_radius`` (default ``radius``; 0 skips it).  Each
    is one launch of the refine kernel with its own schedule.  The JAX
    package scores the subset through strip tables in the same candidate
    order k = dy * diam + dx, masked outside the image, first maximum: the
    window argmax on the gathered subset, so the results are equal.
    Returns refined (B, N, 2) int32 positions.
    """
    B, H, W, F = D11.shape
    N = D21.shape[1]
    budget = min(gate_budget(N, budget_frac), N)
    if subset_dilations is None:
        subset_dilations = tuple(range(dilation_max, 1, -1))
    if final_radius is None:
        final_radius = radius

    D11q = quantize(D11).reshape(B, H * W, F).contiguous()
    D21q = quantize(D21).contiguous()
    p_all = p1.to(torch.int32)
    idx = (p_all[..., 0] + W * p_all[..., 1]).contiguous()
    if len(subset_dilations):
        sel = _compact_unconverged(converged, budget)
        idx_sel = refine_window(D11q, _take(D21q, sel).contiguous(),
                                torch.gather(idx, 1, sel).contiguous(), H, W, radius,
                                tuple(subset_dilations))
        idx = idx.scatter(1, sel, idx_sel)
    if final_radius:
        idx = refine_window(D11q, D21q, idx, H, W, final_radius, (1,))
    return lin_to_pixel(idx, W)


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
          refine_gate: str = "none", refine_budget_frac: float = 0.125,
          refine_subset_dilations=None, refine_final_radius: int = None,
          proj_gate: str = "none", proj_init: str = "warm", proj_pre_iters: int = 2,
          proj_budget_frac: float = 0.125):
    """Dense 1->2 association (reference matching.py:8-90).

    X11, X21: (B, H, W, 3); D11, D21: (B, H, W, F).
    refine_gate: "none" runs the full pyramid on every pixel; "converged"
    runs ``refine_matches_gated`` on the LM's convergence flags.
    proj_gate: "none" or "converged" (``iter_proj``'s gate).
    proj_init: "warm" starts the LM from ``idx_1_to_2_init``; "pinhole" from
    the pinhole fitted to the ray image; "best" from the lower-cost of the
    two per pixel.
    Returns (idx_1_to_2 (B, N) int32, valid (B, N, 1) bool).
    """
    if refine_gate not in GATES:
        raise ValueError(f"match: refine_gate {refine_gate!r}, expected one of {GATES}")
    if proj_init not in PROJ_INITS:
        raise ValueError(f"match: proj_init {proj_init!r}, expected one of {PROJ_INITS}")
    B, H, W, _ = X11.shape
    rays_with_grad, pts3d_norm, p_init = prep_for_iter_proj(X11, X21, idx_1_to_2_init)
    p_alt = None
    if proj_init != "warm":
        p_pin = pinhole_init(rays_with_grad, pts3d_norm)
        if proj_init == "pinhole" or idx_1_to_2_init is None:
            p_init = p_pin
        else:
            p_alt = p_pin
    p1, valid_proj, X11_at = iter_proj(
        rays_with_grad, pts3d_norm, p_init, max_iter=max_iter,
        lambda_init=lambda_init, cost_thresh=convergence_thresh, gate=proj_gate,
        pre_iters=proj_pre_iters, budget_frac=proj_budget_frac, p_init_alt=p_alt,
        extra_img=X11)
    p1 = p1.to(torch.int32)

    dists = vnorm(X11_at - X21.reshape(B, -1, 3), keepdim=False)
    valid = valid_proj & (dists < dist_thresh)

    if radius > 0:
        D21_flat = D21.reshape(B, pts3d_norm.shape[1], -1)
        if refine_gate == "converged":
            p1 = refine_matches_gated(
                D11, D21_flat, p1, valid_proj, radius=radius, dilation_max=dilation_max,
                budget_frac=refine_budget_frac, subset_dilations=refine_subset_dilations,
                final_radius=refine_final_radius)
        else:
            p1 = refine_matches(D11, D21_flat, p1, radius=radius, dilation_max=dilation_max)

    idx_1_to_2 = pixel_to_lin(p1, W).to(torch.int32)
    return idx_1_to_2, valid[..., None]

"""Global Sim(3) Gauss-Newton over keyframe poses (port of ``ops/global_gn.py``).

Per-edge dense residuals over all pixels give one 7x7 block H_e and
gradient g_e per edge (Ji = -Jj, so one block gives all four of the edge's
[ii, ij; ji, jj] blocks); the blocks are scatter-added into the normal
equations, solved (dense Cholesky with Jacobi scaling, or block-sparse
PCG), retracted and iterated.

Ray mode's residual model and block reduction live in ``ops/edge_hg.py``
beside their kernel (``csrc/edge_hg_rays.cu``), launched on the card once
per GN iteration; calib
and points modes stay plain torch on the card too, as the JAX package has
no kernel for them.  Every float32 matrix product here runs in full f32
(``full_f32``), and norms and CG inner products are elementwise products
and sums.

The JAX package's ``lax.while_loop``s are Python loops here: the GN loop
reads (step norm, ok, cost went up) from the device once per iteration, at
most ``max_iters`` times; the PCG loop reads its residual test once per
iteration, at most ``pcg_iters`` times.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import constrain_points_to_ray
from ..lie import sim3
from ..utils.numerics import full_f32, index_add_fixed
from . import edge_hg
from .robust import huber_weight


class GlobalGNSettings(NamedTuple):
    max_iters: int = 10
    delta_norm: float = 1e-8
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    sigma_point: float = 0.05
    C_conf: float = 0.0
    Q_conf: float = 1.5
    pixel_border: float = -10.0
    depth_eps: float = 1e-6
    huber_k: float = 1.345
    pin: int = 1
    edge_batch: int = 8        # edges a calib or points block reduction takes at once
    solver: str = "auto"       # "auto" | "dense" | "pcg"
    dense_max_poses: int = 1024
    pcg_iters: int = 96
    pcg_tol: float = 1e-7
    pcg_damping: float = 1e-4
    hg_impl: str = "auto"      # "auto" | "pallas"; the plain "reduce" | "dot" raise on the card
    pcg_precond: str = "block"  # "block" | "diag"

    @classmethod
    def from_config(cls, cfg) -> "GlobalGNSettings":
        lo = cfg["local_opt"]
        return cls(
            max_iters=lo["max_iters"],
            delta_norm=lo["delta_norm"],
            sigma_ray=lo["sigma_ray"],
            sigma_dist=lo["sigma_dist"],
            sigma_pixel=lo["sigma_pixel"],
            sigma_depth=lo["sigma_depth"],
            sigma_point=lo["sigma_point"],
            C_conf=lo["C_conf"],
            Q_conf=lo["Q_conf"],
            pixel_border=lo["pixel_border"],
            depth_eps=lo["depth_eps"],
            pin=lo["pin"],
            solver=lo.get("solver", "auto"),
            dense_max_poses=lo.get("dense_max_poses",
                                   cls._field_defaults["dense_max_poses"]),
            pcg_iters=lo.get("pcg_iters", 96),
            pcg_tol=lo.get("pcg_tol", 1e-7),
            pcg_damping=lo.get("pcg_damping", 1e-4),
            hg_impl=lo.get("hg_impl", "auto"),
            pcg_precond=lo.get("pcg_precond", "block"),
        )


# ---------------------------------------------------------------------------
# per-edge residual models, batched over a leading edge axis
# ---------------------------------------------------------------------------

def _calib_residuals(Tij, Xi, Xj, K, img_hw, border, z_eps):
    """Pixel + log-depth residual parts.  Tij (E, 8); Xi, Xj (E, N, 3).
    Returns ((u, v, log-depth difference), (fx, fy, x/z, y/z, 1/z), valid
    (E, N, 1))."""
    H, W = img_hw
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    P = sim3.act(Tij[:, None, :], Xj)
    x, y, z = P.unbind(-1)
    zi = Xi[..., 2]
    valid_z = (z > z_eps) & (zi > z_eps)
    one = torch.ones_like(z)
    z_safe = torch.where(valid_z, z, one)
    zi_safe = torch.where(valid_z, zi, one)
    z_inv = 1.0 / z_safe
    xz = x * z_inv
    yz = y * z_inv
    u = fx * xz + cx
    v = fy * yz + cy
    valid_uv = (u > border) & (u < W - 1 - border) & (v > border) & (v < H - 1 - border)
    dlogz = torch.where(valid_z, torch.log(z_safe) - torch.log(zi_safe), torch.zeros_like(z))
    return (u, v, dlogz), (fx, fy, xz, yz, z_inv), (valid_z & valid_uv)[..., None]


def _conjugate(Ti, Mloc):
    """Local-frame Mloc (E, 8, 8) -> world-tangent (H_e (E, 7, 7), g_e (E, 7),
    robust cost (E,)): H_e = M H_l Mᵀ, g_e = M g_l with M the adjoint
    inverse of Ti, applied once per edge."""
    H_l = Mloc[:, :7, :7]
    g_l = Mloc[:, :7, 7]
    Tb = Ti[:, None, :]
    HMt = sim3.apply_adj_inv(Tb, H_l)
    H_e = sim3.apply_adj_inv(Tb, HMt.transpose(1, 2))
    g_e = sim3.apply_adj_inv(Ti, g_l)
    return H_e, g_e, Mloc[:, 7, 7]


def _edge_Hg(Ti, w, err, J_local):
    """(H_e, g_e, cost) from local rows: reduce in the local frame, then
    conjugate once per edge."""
    return _conjugate(Ti, edge_hg.reduce_blocks(w, err, J_local))


def _edge_block_rays(Twc, settings: GlobalGNSettings, edge):
    """Ray+distance blocks of all edges at once: the edge-block kernel on
    the card, its plain form on the CPU."""
    ei, ej, Xi, Xj, sq, _, _ = edge
    Ti = Twc[ei]
    Tij = sim3.rel(Ti, Twc[ej]).contiguous()
    Mloc = edge_hg.edge_hg_rays(
        Tij, Xi, Xj, sq, sigma_ray=settings.sigma_ray,
        sigma_dist=settings.sigma_dist, huber_k=settings.huber_k)
    return _conjugate(Ti, Mloc)


def _edge_block_points(Twc, settings: GlobalGNSettings, edge):
    """Point-to-point blocks: residual Tij Xj - Xi, 3 rows a pixel."""
    ei, ej, Xi, Xj, sq_in, _, _ = edge
    Ti = Twc[ei]
    Tij = sim3.rel(Ti, Twc[ej])
    P = sim3.act(Tij[:, None, :], Xj)
    err = P - Xi
    px, py, pz = P.unbind(-1)
    o = torch.zeros_like(px)
    neg_skew = torch.stack([o, pz, -py, -pz, o, px, py, -px, o], dim=-1)
    neg_skew = neg_skew.reshape(P.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand_as(neg_skew)
    J_local = torch.cat([eye, neg_skew, P[..., :, None]], dim=-1)
    sq = sq_in / settings.sigma_point
    sqrt_w = torch.stack([sq, sq, sq], dim=-1)
    w = huber_weight(sqrt_w * err, settings.huber_k) * sqrt_w * sqrt_w
    return _edge_Hg(Ti, w, err, J_local)


def _edge_block_calib(Twc, K, img_hw, settings: GlobalGNSettings, edge):
    """Pixel + log-depth blocks, the projection validity applied on top of
    the pose-independent gate in sq."""
    ei, ej, Xi, Xj, sq_in, u_t, v_t = edge
    Ti = Twc[ei]
    Tij = sim3.rel(Ti, Twc[ej])
    (u, v, rz), (fx, fy, xz, yz, z_inv), valid_extra = _calib_residuals(
        Tij, Xi, Xj, K, img_hw, settings.pixel_border, settings.depth_eps)
    err = torch.stack([u - u_t, v - v_t, rz], dim=-1)
    o = torch.zeros_like(xz)
    one = torch.ones_like(xz)
    J_u = torch.stack([fx * z_inv, o, -fx * xz * z_inv, -fx * xz * yz,
                       fx * (1 + xz * xz), -fx * yz, o], dim=-1)
    J_v = torch.stack([o, fy * z_inv, -fy * yz * z_inv, -fy * (1 + yz * yz),
                       fy * xz * yz, fy * xz, o], dim=-1)
    J_z = torch.stack([o, o, z_inv, yz, -xz, o, one], dim=-1)
    J_local = torch.stack([J_u, J_v, J_z], dim=-2)
    sq = sq_in * valid_extra[..., 0]
    sqrt_w = torch.stack([sq / settings.sigma_pixel, sq / settings.sigma_pixel,
                          sq / settings.sigma_depth], dim=-1)
    w = huber_weight(sqrt_w * err, settings.huber_k) * sqrt_w * sqrt_w
    return _edge_Hg(Ti, w, err, J_local)


def precompute_edge_data(Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                         settings: GlobalGNSettings, mode: str, img_hw):
    """Gather the per-edge correspondences once, before the GN iterations
    (they do not depend on the poses).  Returns (Xi (E, N, 3), Xj (E, N, 3),
    sq (E, N) valid·sqrt(q), ut, vt (E, N) calib target pixels or zeros)."""
    H, W = img_hw
    Xs = Xs.float()
    Cs = Cs.float()
    Q = Q.float()
    XsC = torch.cat([Xs, Cs], dim=-1)
    rows_i = XsC[ii]
    gath = torch.gather(rows_i, 1, idx_ii2jj.long()[..., None].expand(-1, -1, 4))
    return _edge_fields(gath[..., 0:3], gath[..., 3], Xs[jj], Cs[jj][..., 0],
                        idx_ii2jj, valid_match, Q, settings, mode, W)


def _edge_fields(Xi, ci, Xj, cj, idx_ii2jj, valid_match, Q, settings, mode, W):
    """The confidence gate and weights shared by both GN entries."""
    q = Q[..., 0]
    valid = (valid_match[..., 0] & (q > settings.Q_conf)
             & (ci > settings.C_conf) & (cj > settings.C_conf))
    if mode == "calib":
        valid = valid & (Xi[..., 2] > settings.depth_eps)
        ut = (idx_ii2jj % W).to(Xi.dtype)
        vt = torch.div(idx_ii2jj, W, rounding_mode="floor").to(Xi.dtype)
    else:
        ut = torch.zeros_like(q)
        vt = torch.zeros_like(q)
    sq = torch.sqrt(q) * valid
    return Xi.contiguous(), Xj.contiguous(), sq.contiguous(), ut, vt


# ---------------------------------------------------------------------------
# assembly + solve
# ---------------------------------------------------------------------------

def _slots(ii, jj, pin: int, M: int):
    """Pose indices -> free-pose slots; pinned poses go to the trash slot M."""
    io = torch.where(ii - pin >= 0, ii - pin, torch.full_like(ii, M))
    jo = torch.where(jj - pin >= 0, jj - pin, torch.full_like(jj, M))
    return io.long(), jo.long()


def _assemble_and_solve(H_e, g_e, ii, jj, num_poses: int, pin: int,
                        damping: float = 1e-4):
    """Scatter the edge blocks into dense normal equations and solve them:
    Jacobi scaling, relative Levenberg damping, Cholesky.  H_e (E, 7, 7),
    g_e (E, 7), ii/jj (E,).  Returns (dx (P - pin, 7), ok).  A failed
    factorisation gives ok False and a zero step, as ``cho_factor``'s NaN
    does in the JAX package.  Repeated edges add up, in a fixed order
    (``index_put_`` with accumulate, ``index_add_fixed``)."""
    M = num_poses - pin
    io, jo = _slots(ii, jj, pin, M)
    Hbig = H_e.new_zeros((M + 1, M + 1, 7, 7))
    Hbig.index_put_((io, io), H_e, accumulate=True)
    Hbig.index_put_((jo, jo), H_e, accumulate=True)
    Hbig.index_put_((io, jo), -H_e, accumulate=True)
    Hbig.index_put_((jo, io), -H_e, accumulate=True)
    gbig = g_e.new_zeros((M + 1, 7))
    index_add_fixed(gbig, io, -g_e)
    index_add_fixed(gbig, jo, g_e)

    Hd = Hbig[:M, :M].permute(0, 2, 1, 3).reshape(7 * M, 7 * M)
    gd = gbig[:M].reshape(7 * M)
    d_inv = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(Hd), 1e-12))
    Hs = Hd * d_inv[:, None] * d_inv[None, :]
    Hs = Hs + torch.eye(7 * M, dtype=Hs.dtype, device=Hs.device) * (damping + 1e-8)
    L, info = torch.linalg.cholesky_ex(Hs)
    y = torch.cholesky_solve((gd * d_inv)[:, None], L)[:, 0]
    dx = -(d_inv * y)
    ok = (info == 0) & torch.isfinite(dx).all()
    dx = torch.where(ok, dx, torch.zeros_like(dx))
    return dx.reshape(M, 7), ok


def _dot(a, b):
    return torch.sum(a * b)


def _assemble_and_solve_pcg(H_e, g_e, ii, jj, num_poses: int, pin: int,
                            iters: int, tol: float, damping: float = 1e-4,
                            precond: str = "block"):
    """Block-sparse normal equations solved by preconditioned CG, the
    operator applied edge-wise (gather 7-vectors, multiply 7x7 blocks,
    scatter-add): O(E + M) memory.  The preconditioner is per-pose 7x7
    Cholesky solves ("block") or scalar Jacobi ("diag"); both see the
    relatively damped block diagonal.  Returns (dx (P - pin, 7), ok)."""
    M = num_poses - pin
    H_e = H_e.float()
    g_e = g_e.float()
    io, jo = _slots(ii, jj, pin, M)

    b = g_e.new_zeros((M + 1, 7))
    index_add_fixed(b, io, g_e)
    index_add_fixed(b, jo, -g_e)
    b = b[:M]

    D = H_e.new_zeros((M + 1, 7, 7))
    index_add_fixed(D, io, H_e)
    index_add_fixed(D, jo, H_e)
    D = D[:M]
    tr = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 7.0
    eye7 = torch.eye(7, dtype=D.dtype, device=D.device)
    D = D + (damping + 1e-6) * torch.clamp_min(tr, 1e-12) * eye7

    if precond == "diag":
        dinv = 1.0 / torch.clamp_min(torch.diagonal(D, dim1=-2, dim2=-1), 1e-12)

        def prec(r):
            return r * dinv
    else:
        Lp, info = torch.linalg.cholesky_ex(D)
        # a block that is not positive definite poisons the preconditioner
        # with NaN, as cho_factor does in the JAX package
        Lp = torch.where((info == 0)[:, None, None], Lp, torch.full_like(Lp, float("nan")))

        def prec(r):
            return torch.cholesky_solve(r[..., None], Lp)[..., 0]

    def A_mv(x):  # (D + off-diagonal blocks) x, as products and sums
        xp = torch.cat([x, x.new_zeros((1, 7))])
        y = torch.sum(D * x[:, None, :], dim=-1)
        yi = -torch.sum(H_e * xp[jo][:, None, :], dim=-1)
        yj = -torch.sum(H_e * xp[io][:, None, :], dim=-1)
        acc = x.new_zeros((M + 1, 7))
        index_add_fixed(acc, io, yi)
        index_add_fixed(acc, jo, yj)
        return y + acc[:M]

    tol2 = (tol * tol) * torch.clamp_min(_dot(b, b), 1e-30)
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = _dot(r, z)
    for _ in range(iters):
        # one host read an iteration: the loop's test
        if not bool(((_dot(r, r) > tol2) & torch.isfinite(rz)).item()):
            break
        Ap = A_mv(p)
        alpha = rz / torch.clamp_min(_dot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
    ok = torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok


# ---------------------------------------------------------------------------
# the GN loop
# ---------------------------------------------------------------------------

def _as_index(a, device):
    return torch.as_tensor(a, device=device).long()


@torch.no_grad()
def gauss_newton_poses(Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K, img_hw,
                       settings: GlobalGNSettings, mode: str = "rays"):
    """Iterated global GN over keyframe poses.

    Twc (P, 8); Xs (P, N, 3); Cs (P, N, 1); ii, jj (E,) edge pose indices;
    idx_ii2jj (E, N); valid_match (E, N, 1) bool; Q (E, N, 1).  Returns
    (Twc', iters, ok, diverged): ``diverged`` is the monotone-cost guard, set
    when an iteration raised the robust cost; that step was reverted (Twc'
    is the last good iterate) and the loop stopped.
    """
    dev = Twc.device
    ii, jj = _as_index(ii, dev), _as_index(jj, dev)
    fields = precompute_edge_data(Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                                  settings, mode, img_hw)
    return _gn_core(Twc, ii, jj, *fields, K, img_hw, settings, mode)


@torch.no_grad()
def gauss_newton_poses_cached(Twc, Xs, C_raw, n_fused, ii, jj, gath_f, gath_b,
                              idx_ii2jj, valid_match, Q, K, img_hw,
                              settings: GlobalGNSettings, mode: str = "rays"):
    """GN entry for the factor graph's gathered-point cache.

    gath_f / gath_b (half, N, 4): cached [X | C_raw] rows of each stored
    edge's forward and backward direction (ray-constrained in calib mode);
    ``ii`` / ``jj`` are the two-way (2·half,) pose indices of
    ``cat([gath_f, gath_b])``.  C_raw / n_fused and Xs are the store's raw
    fields: normalisation and the calib ray constraint happen here.
    """
    dev = Twc.device
    ii, jj = _as_index(ii, dev), _as_index(jj, dev)
    nf = torch.clamp_min(n_fused.float(), 1.0)
    Cs = C_raw.float() / nf[:, None, None]
    Xs = Xs.float()
    if mode == "calib":
        Xs = constrain_points_to_ray(img_hw, Xs, K)
    gath = torch.cat([gath_f, gath_b], dim=0).float()
    fields = _edge_fields(gath[..., 0:3], gath[..., 3] / nf[ii][:, None], Xs[jj],
                          Cs[jj][..., 0], idx_ii2jj, valid_match, Q.float(),
                          settings, mode, img_hw[1])
    return _gn_core(Twc, ii, jj, *fields, K, img_hw, settings, mode)


def _gn_core(Twc, ii, jj, Xi_all, Xj_all, sq_all, ut_all, vt_all, K, img_hw,
             settings: GlobalGNSettings, mode: str):
    """The GN loop over precomputed per-edge fields, with the monotone-cost
    health guard."""
    P = Twc.shape[0]
    pin = settings.pin
    if settings.hg_impl not in ("auto", "pallas", "reduce", "dot"):
        raise ValueError(f"unknown hg_impl {settings.hg_impl!r}")
    # every hg_impl reaches the same ray blocks (edge_hg.edge_hg_rays); the
    # JAX package's "reduce" and "dot" name plain forms, which the card refuses
    if mode == "rays" and settings.hg_impl in ("reduce", "dot") and Twc.is_cuda:
        raise NotImplementedError(
            f"local_opt.hg_impl: {settings.hg_impl!r} would run the plain ray "
            "blocks on the card; the port's card path is the edge-block "
            "kernel (hg_impl 'auto' or 'pallas')")
    use_pcg = settings.solver == "pcg" or (
        settings.solver == "auto" and (P - pin) > settings.dense_max_poses)

    if mode == "points":
        block_fn = lambda Twc_, edge: _edge_block_points(Twc_, settings, edge)
    elif mode == "calib":
        block_fn = lambda Twc_, edge: _edge_block_calib(Twc_, K, img_hw, settings, edge)
    elif mode != "rays":
        raise ValueError(f"unknown GN mode {mode!r}")
    edge = (ii, jj, Xi_all, Xj_all, sq_all, ut_all, vt_all)
    E = ii.shape[0]

    def blocks(Twc_):
        if mode == "rays":  # all edges in one launch of the kernel on the card
            return _edge_block_rays(Twc_, settings, edge)
        b = max(1, settings.edge_batch)
        outs = [block_fn(Twc_, tuple(a[s:s + b] for a in edge)) for s in range(0, E, b)]
        return tuple(torch.cat(x) for x in zip(*outs))

    keep = (torch.arange(P, device=Twc.device) >= pin)[:, None]

    def one_iter(Twc_):
        H_e, g_e, c_e = blocks(Twc_)
        cost = torch.sum(c_e)  # robust cost at Twc_, before this step
        if use_pcg:
            dx, ok = _assemble_and_solve_pcg(
                H_e, g_e, ii, jj, P, pin, settings.pcg_iters, settings.pcg_tol,
                settings.pcg_damping, settings.pcg_precond)
        else:
            dx, ok = _assemble_and_solve(H_e, g_e, ii, jj, P, pin, settings.pcg_damping)
        dx_full = torch.cat([dx.new_zeros((pin, 7)), dx], dim=0)
        Twc_new = torch.where(keep, sim3.retr(Twc_, dx_full), Twc_)
        return Twc_new, torch.sqrt(torch.sum(dx * dx)), ok, cost

    # monotone-cost guard: each iteration checks that the previous step did
    # not raise the robust cost (by more than 1 %); a step that did is
    # reverted and the loop stops with `diverged` set
    with full_f32():
        Twc_cur, Twc_prev = Twc, Twc
        prev_cost = torch.full((), float("inf"), dtype=torch.float32, device=Twc.device)
        it, ok, diverged = 0, True, False
        while it < settings.max_iters:
            Twc_new, delta, ok_t, cost = one_iter(Twc_cur)
            worse = cost > prev_cost * 1.01
            Twc_cur, Twc_prev = torch.where(worse, Twc_prev, Twc_new), Twc_cur
            prev_cost = torch.where(worse, prev_cost, cost)
            it += 1
            # one host read an iteration: (step norm, ok, cost went up)
            delta_h, ok_h, worse_h = torch.stack(
                [delta.float(), ok_t.float(), worse.float()]).tolist()
            ok, diverged = bool(ok_h), bool(worse_h)
            if delta_h < settings.delta_norm or not ok or diverged:
                break
    return Twc_cur, it, ok, diverged

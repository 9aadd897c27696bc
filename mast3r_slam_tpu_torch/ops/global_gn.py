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

The JAX package runs the GN loop and, on the PCG route, the CG loop
inside it as ``lax.while_loop``s on the device.  On the card a solve is
one device program (``global_gn_graph``): the solve's pieces (``_Pieces``:
the prologue, then a GN iteration, on the PCG route split around the CG
iteration) captured once each and joined under WHILE nodes
(``csrc/gn_while.cu``), so a launch runs the iterations the JAX loops run
and stops where they stop, and the host reads nothing.  A program is built
per (entry, mode, route, shapes, device, settings); the factor graph pads
every solve to the JAX package's buckets, so a session meets few of them.
On the CPU the plain version runs: ``gn_loop``, ``max_iters`` iterations
frozen on the device once the JAX condition fails, with the same bits;
its PCG loop reads its test once a CG iteration.  The edge-sharded route
(``parallel/sharded_ba.py``) builds its one-card program from these pieces
(``_Pieces``, ``_program``) and, across processes or cards, runs
``gn_loop`` with ``early_exit``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import to_host
from ..geometry import constrain_points_to_ray
from ..lie import sim3
from ..utils.numerics import full_f32, index_add_fixed
from . import edge_hg, gn_program, kernels
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


def _scatter_dense(H_e, g_e, io, jo, M: int):
    """Scatter the edge blocks into dense normal equations over M free-pose
    slots plus the trash slot M: (Hbig (M+1, M+1, 7, 7), gbig (M+1, 7)).
    Repeated edges add up in a fixed order (``index_add_fixed``)."""
    Hbig = H_e.new_zeros((M + 1, M + 1, 7, 7))
    Hflat = Hbig.view((M + 1) * (M + 1), 7, 7)
    index_add_fixed(Hflat, io * (M + 1) + io, H_e)
    index_add_fixed(Hflat, jo * (M + 1) + jo, H_e)
    index_add_fixed(Hflat, io * (M + 1) + jo, -H_e)
    index_add_fixed(Hflat, jo * (M + 1) + io, -H_e)
    gbig = g_e.new_zeros((M + 1, 7))
    index_add_fixed(gbig, io, -g_e)
    index_add_fixed(gbig, jo, g_e)
    return Hbig, gbig


def _solve_dense(Hbig, gbig, M: int, damping: float = 1e-4):
    """Solve assembled normal equations: Jacobi scaling, relative Levenberg
    damping, Cholesky.  Returns (dx (M, 7), ok).  A failed factorisation
    gives ok False and a zero step, as ``cho_factor``'s NaN does in the JAX
    package."""
    Hd = Hbig[:M, :M].permute(0, 2, 1, 3).reshape(7 * M, 7 * M)
    gd = gbig[:M].reshape(7 * M)
    d_inv = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(Hd), 1e-12))
    Hs = Hd * d_inv[:, None] * d_inv[None, :]
    Hs = Hs + torch.eye(7 * M, dtype=Hs.dtype, device=Hs.device) * (damping + 1e-8)
    L, info = torch.linalg.cholesky_ex(Hs)
    # the factor's two triangular solves: cholesky_solve (cuSOLVER's potrs)
    # may allocate memory inside a capture, which no graph loop can hold
    y = torch.linalg.solve_triangular(L, (gd * d_inv)[:, None], upper=False)
    y = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    dx = -(d_inv * y)
    ok = (info == 0) & torch.isfinite(dx).all()
    dx = torch.where(ok, dx, torch.zeros_like(dx))
    return dx.reshape(M, 7), ok


def _assemble_and_solve(H_e, g_e, ii, jj, num_poses: int, pin: int,
                        damping: float = 1e-4):
    """The edge blocks scattered (``_scatter_dense``) and solved
    (``_solve_dense``).  H_e (E, 7, 7), g_e (E, 7), ii/jj (E,).  Returns
    (dx (P - pin, 7), ok)."""
    M = num_poses - pin
    io, jo = _slots(ii, jj, pin, M)
    return _solve_dense(*_scatter_dense(H_e, g_e, io, jo, M), M, damping)


def _dot(a, b):
    return torch.sum(a * b)


def _pcg_system(H_e, g_e, io, jo, M: int, damping: float, precond: str):
    """The block-sparse normal equations of one GN iteration: (A_mv, prec,
    b), the operator applied edge-wise (gather 7-vectors, multiply 7x7
    blocks, scatter-add: O(E + M) memory), the preconditioner (per-pose 7x7
    Cholesky solves, "block", or scalar Jacobi, "diag"; both see the
    relatively damped block diagonal) and the right-hand side (M, 7)."""
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

        def prec(r):  # two triangular solves, as in _solve_dense
            y = torch.linalg.solve_triangular(Lp, r[..., None], upper=False)
            return torch.linalg.solve_triangular(Lp.mT, y, upper=True)[..., 0]

    def A_mv(x):  # (D + off-diagonal blocks) x, as products and sums
        xp = torch.cat([x, x.new_zeros((1, 7))])
        y = torch.sum(D * x[:, None, :], dim=-1)
        yi = -torch.sum(H_e * xp[jo][:, None, :], dim=-1)
        yj = -torch.sum(H_e * xp[io][:, None, :], dim=-1)
        acc = x.new_zeros((M + 1, 7))
        index_add_fixed(acc, io, yi)
        index_add_fixed(acc, jo, yj)
        return y + acc[:M]

    return A_mv, prec, b


def _pcg_start(b, prec, tol: float):
    """The CG loop's initial state (x, r, z, p, rz) and its squared
    tolerance."""
    tol2 = (tol * tol) * torch.clamp_min(_dot(b, b), 1e-30)
    z = prec(b)
    return (torch.zeros_like(b), b, z, z, _dot(b, z)), tol2


def _cg_test(r, rz, tol2):
    """The CG loop's test, the JAX ``cond`` (global_gn.py:500-502) but the
    count: the residual above the tolerance and rz finite."""
    return (_dot(r, r) > tol2) & torch.isfinite(rz)


def _cg_step(A_mv, prec, x, r, z, p, rz):
    """One CG iteration, the JAX ``body`` (global_gn.py:504-513)."""
    Ap = A_mv(p)
    alpha = rz / torch.clamp_min(_dot(p, Ap), 1e-30)
    x = x + alpha * p
    r = r - alpha * Ap
    z = prec(r)
    rz_new = _dot(r, z)
    beta = rz_new / torch.clamp_min(rz, 1e-30)
    p = z + beta * p
    return x, r, z, p, rz_new


def _pcg_result(x):
    """(dx, ok): a non-finite solution gives ok False and a zero step."""
    ok = torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok


def _assemble_and_solve_pcg(H_e, g_e, ii, jj, num_poses: int, pin: int,
                            iters: int, tol: float, damping: float = 1e-4,
                            precond: str = "block", active=True):
    """Block-sparse normal equations (``_pcg_system``) solved by
    preconditioned CG, the plain loop: its test is read once a CG
    iteration, at most ``iters`` times.  ``active`` (a device flag: the
    frozen GN loop's) joins that test, so a frozen GN iteration leaves after
    the first read.  Returns (dx (P - pin, 7), ok)."""
    M = num_poses - pin
    io, jo = _slots(ii, jj, pin, M)
    A_mv, prec, b = _pcg_system(H_e.float(), g_e.float(), io, jo, M, damping, precond)
    state, tol2 = _pcg_start(b, prec, tol)
    for _ in range(iters):
        # one host read an iteration: the loop's test
        if not bool((active & _cg_test(state[1], state[4], tol2)).item()):
            break
        state = _cg_step(A_mv, prec, *state)
    return _pcg_result(state[0])


# ---------------------------------------------------------------------------
# the GN loop
# ---------------------------------------------------------------------------

def _as_index(a, device):
    return torch.as_tensor(a, device=device).long()


def routes_pcg(settings: GlobalGNSettings, num_poses: int) -> bool:
    """The solver route of a solve over ``num_poses`` poses (the JAX
    ``_gn_core``'s static choice, global_gn.py:642-644): PCG when asked, or
    under "auto" past ``dense_max_poses`` free poses."""
    return settings.solver == "pcg" or (
        settings.solver == "auto" and (num_poses - settings.pin) > settings.dense_max_poses)


@torch.no_grad()
def gauss_newton_poses(Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, K, img_hw,
                       settings: GlobalGNSettings, mode: str = "rays"):
    """Iterated global GN over keyframe poses.

    Twc (P, 8); Xs (P, N, 3); Cs (P, N, 1); ii, jj (E,) edge pose indices;
    idx_ii2jj (E, N); valid_match (E, N, 1) bool; Q (E, N, 1).  Returns
    (Twc', iters, ok, diverged): ``diverged`` is the monotone-cost guard, set
    when an iteration raised the robust cost; that step was reverted (Twc'
    is the last good iterate) and the loop stopped.  On a CUDA tensor the
    solve is one launch of its device program (``global_gn_graph``).
    """
    dev = Twc.device
    return _solve("poses", (Twc, Xs, Cs, _as_index(ii, dev), _as_index(jj, dev), idx_ii2jj,
                            valid_match, Q, K), img_hw, settings, mode)


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
    return _solve("cached", (Twc, Xs, C_raw, n_fused, _as_index(ii, dev), _as_index(jj, dev),
                             gath_f, gath_b, idx_ii2jj, valid_match, Q, K),
                  img_hw, settings, mode)


def _entry_fields(entry: str, inputs, img_hw, settings: GlobalGNSettings, mode: str):
    """The edges (ii, jj, Xi, Xj, sq, ut, vt) from an entry's inputs: the
    correspondences gathered once (they do not depend on the poses)."""
    if entry == "poses":
        _, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q, _ = inputs
        return (ii, jj) + tuple(precompute_edge_data(Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                                                     Q, settings, mode, img_hw))
    _, Xs, C_raw, n_fused, ii, jj, gath_f, gath_b, idx_ii2jj, valid_match, Q, K = inputs
    nf = torch.clamp_min(n_fused.float(), 1.0)
    Cs = C_raw.float() / nf[:, None, None]
    Xs = Xs.float()
    if mode == "calib":
        Xs = constrain_points_to_ray(img_hw, Xs, K)
    gath = torch.cat([gath_f, gath_b], dim=0).float()
    return (ii, jj) + tuple(_edge_fields(gath[..., 0:3], gath[..., 3] / nf[ii][:, None],
                                         Xs[jj], Cs[jj][..., 0], idx_ii2jj, valid_match,
                                         Q.float(), settings, mode, img_hw[1]))


def _solve(entry: str, inputs, img_hw, settings: GlobalGNSettings, mode: str):
    """A solve on the inputs' device: the device program on the card, the
    plain loop (``gn_loop``) on the CPU."""
    Twc = inputs[0]
    check_hg_impl(settings, mode, Twc.is_cuda)
    if Twc.is_cuda:
        return global_gn_graph(entry, inputs, img_hw, settings, mode)
    return _gn_core(Twc, *_entry_fields(entry, inputs, img_hw, settings, mode), inputs[-1],
                    img_hw, settings, mode)


def check_hg_impl(settings: GlobalGNSettings, mode: str, on_cuda: bool) -> None:
    """Refuse an unknown ``hg_impl``, and a plain one for ray blocks on the
    card: every hg_impl reaches the same ray blocks (``edge_hg.edge_hg_rays``);
    the JAX package's "reduce" and "dot" name plain forms."""
    if settings.hg_impl not in ("auto", "pallas", "reduce", "dot"):
        raise ValueError(f"unknown hg_impl {settings.hg_impl!r}")
    if mode == "rays" and settings.hg_impl in ("reduce", "dot") and on_cuda:
        raise NotImplementedError(
            f"local_opt.hg_impl: {settings.hg_impl!r} would run the plain ray "
            "blocks on the card; the port's card path is the edge-block "
            "kernel (hg_impl 'auto' or 'pallas')")
    if mode not in ("rays", "points", "calib"):
        raise ValueError(f"unknown GN mode {mode!r}")


def edge_blocks(Twc, edge, K, img_hw, settings: GlobalGNSettings, mode: str):
    """(H_e (E, 7, 7), g_e (E, 7), cost (E,)) of the edges ``edge`` = (ii,
    jj, Xi, Xj, sq, ut, vt) at poses Twc: rays in one launch of the
    edge-block kernel on the card, calib and points in batches of
    ``edge_batch`` edges."""
    if mode == "rays":
        return _edge_block_rays(Twc, settings, edge)
    if mode == "points":
        block_fn = lambda e: _edge_block_points(Twc, settings, e)
    else:
        block_fn = lambda e: _edge_block_calib(Twc, K, img_hw, settings, e)
    b = max(1, settings.edge_batch)
    E = edge[0].shape[0]
    outs = [block_fn(tuple(a[s:s + b] for a in edge)) for s in range(0, E, b)]
    return tuple(torch.cat(x) for x in zip(*outs))


def _gn_core(Twc, ii, jj, Xi_all, Xj_all, sq_all, ut_all, vt_all, K, img_hw,
             settings: GlobalGNSettings, mode: str):
    """The plain GN loop over precomputed per-edge fields, with the
    monotone-cost health guard."""
    P = Twc.shape[0]
    pin = settings.pin
    check_hg_impl(settings, mode, Twc.is_cuda)
    use_pcg = routes_pcg(settings, P)
    edge = (ii, jj, Xi_all, Xj_all, sq_all, ut_all, vt_all)

    def step(Twc_, active):
        H_e, g_e, c_e = edge_blocks(Twc_, edge, K, img_hw, settings, mode)
        cost = torch.sum(c_e)  # robust cost at Twc_, before this step
        if use_pcg:
            dx, ok = _assemble_and_solve_pcg(
                H_e, g_e, ii, jj, P, pin, settings.pcg_iters, settings.pcg_tol,
                settings.pcg_damping, settings.pcg_precond, active)
        else:
            dx, ok = _assemble_and_solve(H_e, g_e, ii, jj, P, pin, settings.pcg_damping)
        return dx, ok, cost

    return gn_loop(Twc, step, settings)


def _gn_advance(Twc, Twc_prev, prev_cost, dx, ok, cost, keep, pin: int, delta_norm: float):
    """The end of one GN iteration from its step ``dx`` (P - pin, 7), the
    solve's ``ok`` and the robust cost at ``Twc`` (before the step): the
    retraction of the free poses and the monotone-cost guard, the JAX
    ``body`` (global_gn.py:733-741).  The guard checks that the previous
    step did not raise the cost (by more than 1 %); a step that did is
    reverted.  Returns (Twc', prev_cost', worse, active'): ``active'`` is
    the JAX ``cond`` after this iteration but its count (step norm at least
    ``delta_norm``, ok, not diverged)."""
    dx_full = torch.cat([dx.new_zeros((pin, 7)), dx], dim=0)
    Twc_new = torch.where(keep, sim3.retr(Twc, dx_full), Twc)
    delta = torch.sqrt(torch.sum(dx * dx))
    worse = cost > prev_cost * 1.01
    Twc_out = torch.where(worse, Twc_prev, Twc_new)
    return (Twc_out, torch.where(worse, prev_cost, cost), worse,
            (delta >= delta_norm) & ok & ~worse)


def gn_loop(Twc, step, settings: GlobalGNSettings, early_exit: bool = False):
    """Iterate ``step(Twc, active) -> (dx (P - pin, 7), ok, cost at Twc)``
    (``active`` the loop's device flag, below) under ``_gn_advance``: the
    plain version of the device program.  The JAX ``while_loop``
    (global_gn.py:724-753) as ``max_iters`` iterations under its ``cond``
    as a sticky device flag: once the flag clears the state stays frozen,
    so nothing is read from the device.  With ``early_exit`` the flag is
    read once an iteration (``to_host``) and the loop stops where it
    clears, so ``step`` runs ``iters`` times, with the same bits: the
    edge-sharded route's loop across processes or cards, whose step runs
    collectives (every rank holds the same flag, so the ranks stop
    together).  Returns (Twc', iters, ok, diverged), the last three device
    scalars."""
    P = Twc.shape[0]
    pin = settings.pin
    dev = Twc.device
    keep = (torch.arange(P, device=dev) >= pin)[:, None]
    with full_f32():
        Twc_cur, Twc_prev = Twc, Twc
        prev_cost = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        ok = torch.ones((), dtype=torch.bool, device=dev)
        diverged = torch.zeros((), dtype=torch.bool, device=dev)
        active = ok
        for _ in range(settings.max_iters):
            dx, ok_t, cost = step(Twc_cur, active)
            Twc_out, cost_out, worse, go = _gn_advance(
                Twc_cur, Twc_prev, prev_cost, dx, ok_t, cost, keep, pin, settings.delta_norm)
            Twc_cur, Twc_prev = (torch.where(active, Twc_out, Twc_cur),
                                 torch.where(active, Twc_cur, Twc_prev))
            prev_cost = torch.where(active, cost_out, prev_cost)
            iters = iters + active.to(iters.dtype)
            ok = torch.where(active, ok_t, ok)
            diverged = torch.where(active, worse, diverged)
            active = active & go
            if early_exit and not bool(to_host(active)[0]):
                break
    return Twc_cur, iters, ok, diverged


# ---------------------------------------------------------------------------
# the device program
# ---------------------------------------------------------------------------

class _Pieces:
    """One solve as pieces that update fixed buffers in place, the device
    program's captures.  ``prologue``: the edges' fields from the inputs,
    then the loop state (poses, previous poses, ``prev_cost`` inf, ``ok``,
    ``diverged``, ``active`` True, ``iters`` 0).  A GN iteration: ``body``
    on the dense route; on the PCG route ``pre`` (the edge blocks, the
    system, the preconditioner, the CG state and its first test into
    ``cg_go``, ``cg_it`` 0), then ``cg`` (one CG iteration and its next
    test) while ``cg_go`` holds and ``cg_it`` < ``pcg_iters``, then
    ``post`` (the step, the retraction, the guard, ``active``).  Whoever
    runs the loops counts ``iters`` and ``cg_it`` (on the card the WHILE
    nodes' kernels, csrc/gn_while.cu).  Run in that order, the pieces give
    ``gn_loop``'s bits and its iteration count.  ``dense`` keeps the dense
    route whatever the settings say (the edge-sharded solve's, whose
    subclass gathers its shards' fields in ``_fields`` and sums their
    systems in ``body``)."""

    def __init__(self, entry: str, inputs, img_hw, settings: GlobalGNSettings, mode: str,
                 dense: bool = False):
        self.entry, self.inputs, self.img_hw = entry, inputs, tuple(img_hw)
        self.settings, self.mode = settings, mode
        Twc = inputs[0]
        dev = Twc.device
        self.P = Twc.shape[0]
        self.M = self.P - settings.pin
        self.use_pcg = not dense and routes_pcg(settings, self.P)
        self.keep = (torch.arange(self.P, device=dev) >= settings.pin)[:, None]

        def scalar(dtype):
            return torch.empty((), dtype=dtype, device=dev)

        self.Twc = torch.empty_like(Twc)
        self.Twc_prev = torch.empty_like(Twc)
        self.prev_cost, self.cost = scalar(torch.float32), scalar(torch.float32)
        self.ok, self.diverged, self.active = (scalar(torch.bool) for _ in range(3))
        self.iters = scalar(torch.int32)
        inner = None
        if self.use_pcg:
            self.x, self.r, self.z, self.p = (
                torch.empty((self.M, 7), dtype=torch.float32, device=dev) for _ in range(4))
            self.rz, self.tol2 = scalar(torch.float32), scalar(torch.float32)
            self.cg_go, self.cg_it = scalar(torch.bool), scalar(torch.int32)
            inner = gn_program.Loop(self.cg_go, self.cg_it, settings.pcg_iters)
        self.loops = (gn_program.Loop(self.active, self.iters, settings.max_iters), inner)
        self.edge = None   # the prologue's
        self._ops = None   # the PCG operator and preconditioner, pre's
        self.stand_in = False

    def _fields(self):
        """The edges' fields, gathered once from the inputs."""
        return _entry_fields(self.entry, self.inputs, self.img_hw, self.settings, self.mode)

    def prologue(self):
        self.edge = self._fields()
        Twc = self.inputs[0]
        self.Twc.copy_(Twc)
        self.Twc_prev.copy_(Twc)
        self.prev_cost.fill_(float("inf"))
        self.ok.fill_(True)
        self.diverged.fill_(False)
        self.active.fill_(True)
        self.iters.zero_()

    def _edge_blocks(self, Twc, edge, K, img_hw, settings: GlobalGNSettings, mode: str):
        """``edge_blocks``, or during a program's warm-up stand-in blocks of
        the same shapes (no kernel launch)."""
        if self.stand_in:
            E = edge[0].shape[0]
            dev = Twc.device
            return (torch.eye(7, device=dev).expand(E, 7, 7).contiguous(),
                    torch.zeros((E, 7), device=dev), torch.zeros((E,), device=dev))
        return edge_blocks(Twc, edge, K, img_hw, settings, mode)

    def _blocks(self):
        return self._edge_blocks(self.Twc, self.edge, self.inputs[-1], self.img_hw,
                                 self.settings, self.mode)

    def _advance(self, dx, ok, cost):
        s = self.settings
        Twc_out, cost_out, worse, go = _gn_advance(
            self.Twc, self.Twc_prev, self.prev_cost, dx, ok, cost, self.keep, s.pin,
            s.delta_norm)
        self.Twc_prev.copy_(self.Twc)
        self.Twc.copy_(Twc_out)
        self.prev_cost.copy_(cost_out)
        self.ok.copy_(ok)
        self.diverged.copy_(worse)
        self.active.copy_(go)

    def body(self):
        s = self.settings
        H_e, g_e, c_e = self._blocks()
        cost = torch.sum(c_e)  # robust cost at Twc, before this step
        dx, ok = _assemble_and_solve(H_e, g_e, self.edge[0], self.edge[1], self.P, s.pin,
                                     s.pcg_damping)
        self._advance(dx, ok, cost)

    def pre(self):
        s = self.settings
        H_e, g_e, c_e = self._blocks()
        self.cost.copy_(torch.sum(c_e))
        io, jo = _slots(self.edge[0], self.edge[1], s.pin, self.M)
        A_mv, prec, b = _pcg_system(H_e.float(), g_e.float(), io, jo, self.M, s.pcg_damping,
                                    s.pcg_precond)
        state, tol2 = _pcg_start(b, prec, s.pcg_tol)
        for dst, src in zip((self.x, self.r, self.z, self.p, self.rz), state):
            dst.copy_(src)
        self.tol2.copy_(tol2)
        self.cg_go.copy_(_cg_test(state[1], state[4], tol2))
        self.cg_it.zero_()
        self._ops = (A_mv, prec)

    def cg(self):
        state = _cg_step(*self._ops, self.x, self.r, self.z, self.p, self.rz)
        for dst, src in zip((self.x, self.r, self.z, self.p, self.rz), state):
            dst.copy_(src)
        self.cg_go.copy_(_cg_test(state[1], state[4], self.tol2))

    def post(self):
        self._advance(*_pcg_result(self.x), self.cost)

    def parts(self):
        """The pieces a program captures, in its order."""
        return (self.prologue,) + ((self.pre, self.cg, self.post) if self.use_pcg
                                   else (self.body,))

    def warm_up(self):
        """Every piece once with stand-in blocks (no edge-block launch); the
        edge-block kernel's library, occupancy and run count made on the
        card."""
        if self.mode == "rays" and self.Twc.is_cuda:
            edge_hg.card_slots(self.Twc.device)
        self.stand_in = True
        for part in self.parts():
            part()
        self.stand_in = False

    def outputs(self):
        return (self.Twc, self.iters, self.ok, self.diverged)


# launches of the global GN's device program (one a solve on the card)
counter = kernels.LaunchCounter("global_gn_while")
_programs = gn_program.ProgramCache()


def global_gn_graph(entry: str, inputs, img_hw, settings: GlobalGNSettings, mode: str):
    """The solve on the card, ``gn_loop``'s results: ``entry`` "poses"
    (``gauss_newton_poses``'s inputs Twc ... K) or "cached"
    (``gauss_newton_poses_cached``'s), every input on the card and ii/jj
    int64.  The device program of (entry, mode, route, input shapes, device,
    image size, settings) is built at its first call (``gn_program``); the
    programs kept on a device hold at most ``gn_program.PROGRAM_BYTES``,
    the least recently used dropped first.  A build that fails raises."""
    Twc = inputs[0]
    if not Twc.is_cuda:
        raise ValueError("global_gn_graph runs on a CUDA device")
    dev = Twc.device
    if settings.max_iters < 1:  # the loop's first test fails: nothing runs
        return (Twc.clone(), torch.zeros((), dtype=torch.int32, device=dev),
                torch.ones((), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    route = "pcg" if routes_pcg(settings, Twc.shape[0]) else "dense"
    key = (dev, entry, route, mode, tuple((a.shape, a.dtype) for a in inputs),
           tuple(img_hw), settings)
    return _program(key, lambda static: _Pieces(entry, static, img_hw, settings, mode),
                    inputs)


def _program(key: tuple, make, inputs):
    """The outputs of the device program of ``key`` on ``inputs``; at its
    first call built from ``make(static inputs) -> pieces``.  Every global
    GN program, the edge-sharded one's too, counts its launches in
    ``counter`` and is kept in one cache, within one budget."""

    def build():
        with full_f32():
            return gn_program.Program(make, inputs, counter)

    return _programs.run(key, build, inputs)


def programs() -> list:
    """(key, bytes held) of the device programs kept, least recently used
    first."""
    return _programs.held()


def programs_built() -> int:
    """Device programs built so far in this process."""
    return _programs.built


def clear_programs() -> None:
    """Drop every device program (its graph and captured memory)."""
    _programs.clear()

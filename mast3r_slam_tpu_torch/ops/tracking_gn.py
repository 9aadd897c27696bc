"""Frame-to-keyframe Sim(3) Gauss-Newton pose solvers.

Port of ``mast3r_slam_tpu/ops/tracking_gn.py``.  The JAX package runs the
<=50-iteration loop in ``lax.while_loop`` on the device; here it is a Python
loop that reads two flags (converged, ok) from the device once per
iteration.  A failed Cholesky (``cholesky_ex`` info != 0) or a non-finite
step gives ``ok = False`` and a zero step, as ``cho_factor``'s NaN does in
the JAX package.

Residual models: ray + distance (uncalibrated, tracker.py:173-214) and
pixel + log-depth (calibrated, tracker.py:216-266).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import act_sim3, point_to_ray_dist, project_calib, tau_jacobian
from ..lie import sim3
from .robust import huber_weight


class GNSettings(NamedTuple):
    max_iters: int = 50
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    huber_k: float = 1.345
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: float = -10.0
    depth_eps: float = 1e-6


def _solve_normal_eqs(sqrt_info, r, J, huber_k):
    """Whiten, robust-reweight, assemble H/g/cost from one augmented
    [J | r]^T [J | r] reduction and solve the 7-dof step.
    sqrt_info, r: (N, R); J: (N, R, 7).  Returns (tau (7,), cost, ok)."""
    whitened = sqrt_info * r
    robust = sqrt_info * torch.sqrt(huber_weight(whitened, huber_k))
    Ab = (robust[..., None] * torch.cat([J, r[..., None]], dim=-1)).reshape(-1, 8)
    M = Ab.T @ Ab
    H = M[:7, :7]
    g = -M[:7, 7]
    cost = 0.5 * M[7, 7]
    L, info = torch.linalg.cholesky_ex(H)
    tau = torch.cholesky_solve(g[:, None], L)[:, 0]
    ok = (info == 0) & torch.isfinite(tau).all()
    tau = torch.where(ok, tau, torch.zeros_like(tau))
    return tau, cost, ok


def _gn_loop(residual_fn, T_init, settings: GNSettings):
    """residual_fn(T) -> (sqrt_info, r, J).  Returns (T, cost, ok)."""
    T = T_init
    cost = torch.full((), float("inf"), dtype=torch.float32, device=T.device)
    ok = torch.ones((), dtype=torch.bool, device=T.device)
    for _ in range(settings.max_iters):
        sqrt_info, r, J = residual_fn(T)
        old_cost = cost
        tau, cost, ok = _solve_normal_eqs(sqrt_info, r, J, settings.huber_k)
        T = sim3.retr(T, tau)
        # check_convergence (nonlinear_optimizer.py:5-26)
        rel_dec = torch.abs((old_cost - cost) / torch.clamp_min(old_cost, 1e-30))
        delta = torch.sqrt(torch.sum(tau * tau))
        converged = (rel_dec < settings.rel_error) | (delta < settings.delta_norm)
        done, good = torch.stack([converged, ok]).tolist()  # one device read
        if done or not good:
            break
    return T, cost, ok


def opt_pose_ray_dist_sim3(Xf, Xk, T_CkCf_init, Qk, valid, settings: GNSettings):
    """Uncalibrated ray + distance pose solve.

    Xf: (N, 3) matched frame points; Xk: (N, 3) keyframe points;
    T_CkCf_init: (8,); Qk: (N, 1) confidence; valid: (N, 1) float mask.
    Returns (T_CkCf (8,), cost, ok).
    """
    w = valid * torch.sqrt(Qk)
    sqrt_info = torch.cat(
        [(w / settings.sigma_ray).expand(-1, 3), w / settings.sigma_dist], dim=-1)
    rd_k = point_to_ray_dist(Xk)

    def residual_fn(T):
        Y = act_sim3(T, Xf)
        rd_f, drd_dX = point_to_ray_dist(Y, jacobian=True)
        return sqrt_info, rd_k - rd_f, -tau_jacobian(drd_dX, Y)

    return _gn_loop(residual_fn, T_CkCf_init, settings)


def opt_pose_calib_sim3(Xf, Xk, T_CkCf_init, Qk, valid, meas_k, valid_meas_k, K,
                        img_size, settings: GNSettings):
    """Calibrated pixel + log-depth pose solve.

    meas_k: (N, 3) [u, v, log z] keyframe measurements; valid_meas_k: (N, 1).
    """
    w = valid * torch.sqrt(Qk)
    sqrt_info = torch.cat(
        [(w / settings.sigma_pixel).expand(-1, 2), w / settings.sigma_depth], dim=-1)

    def residual_fn(T):
        Y = act_sim3(T, Xf)
        pz, dpz_dX, valid_proj = project_calib(
            Y, K, img_size, jacobian=True, border=settings.pixel_border,
            z_eps=settings.depth_eps)
        info = (valid_proj & valid_meas_k) * sqrt_info
        return info, meas_k - pz, -tau_jacobian(dpz_dX, Y)

    return _gn_loop(residual_fn, T_CkCf_init, settings)

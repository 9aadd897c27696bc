"""Frame-to-keyframe Sim(3) Gauss-Newton pose solvers.

Port of ``mast3r_slam_tpu/ops/tracking_gn.py``.  The JAX package runs the
<=50-iteration loop in ``lax.while_loop`` on the device and the host never
reads it.  Here the loop runs a fixed ``max_iters`` iterations (``_gn_loop``)
and a sticky device flag, the JAX ``cond``'s ``~done & ok``, decides whether
each one takes effect: once it clears, ``T``, ``cost`` and ``ok`` stay
frozen (``torch.where``), so the results are the early-exit loop's, bit for
bit, and nothing is read from the device.  A failed Cholesky
(``cholesky_ex`` info != 0) or a non-finite step gives ``ok = False`` and a
zero step, as ``cho_factor``'s NaN does in the JAX package.

On the CPU the loop runs eagerly (the plain version).  On the card it is
one device program, built once per (residual model, input shapes, device,
settings) and launched on the caller's current stream: ``_Pieces``
splits the loop into a prologue and one iteration, which
``gn_program.Program`` captures in CUDA graphs and repeats under a WHILE
conditional node (``csrc/gn_while.cu``), which stops after the last
active iteration, as the JAX ``while_loop`` does.

Residual models: ray + distance (uncalibrated, tracker.py:173-214) and
pixel + log-depth (calibrated, tracker.py:216-266).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import act_sim3, point_to_ray_dist, project_calib, tau_jacobian
from ..lie import sim3
from . import gn_program, kernels
from .robust import huber_weight

# launches of the tracking GN's device program (one a solve on the card)
counter = kernels.LaunchCounter("tracking_gn_while")


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
    # the factor's two triangular solves: cholesky_solve (cuSOLVER's potrs)
    # may allocate memory inside a capture, which no graph loop can hold
    L, info = torch.linalg.cholesky_ex(H)
    y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
    tau = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    ok = (info == 0) & torch.isfinite(tau).all()
    tau = torch.where(ok, tau, torch.zeros_like(tau))
    return tau, cost, ok


def _gn_step(residual_fn, T, old_cost, settings: GNSettings):
    """One GN iteration from (T, the previous cost): returns (T', cost, ok,
    converged), the JAX ``body`` (tracking_gn.py:71-80)."""
    sqrt_info, r, J = residual_fn(T)
    tau, cost, ok = _solve_normal_eqs(sqrt_info, r, J, settings.huber_k)
    T_new = sim3.retr(T, tau)
    # check_convergence (nonlinear_optimizer.py:5-26)
    rel_dec = torch.abs((old_cost - cost) / torch.clamp_min(old_cost, 1e-30))
    delta = torch.sqrt(torch.sum(tau * tau))
    converged = (rel_dec < settings.rel_error) | (delta < settings.delta_norm)
    return T_new, cost, ok, converged


def _gn_loop(residual_fn, T_init, settings: GNSettings):
    """residual_fn(T) -> (sqrt_info, r, J).  ``max_iters`` iterations, each
    taking effect while ``active`` holds.  Returns (T, cost, ok, iterations
    that took effect)."""
    T = T_init
    cost = torch.full((), float("inf"), dtype=torch.float32, device=T.device)
    ok = torch.ones((), dtype=torch.bool, device=T.device)
    iters = torch.zeros((), dtype=torch.int32, device=T.device)
    active = ok
    for _ in range(settings.max_iters):
        T_new, cost_new, ok_new, converged = _gn_step(residual_fn, T, cost, settings)
        T = torch.where(active, T_new, T)
        cost = torch.where(active, cost_new, cost)
        ok = torch.where(active, ok_new, ok)
        iters = iters + active.to(iters.dtype)
        active = active & ~converged & ok_new
    return T, cost, ok, iters


def _ray_dist_problem(settings: GNSettings, Xf, Xk, Qk, valid):
    """The ray + distance residual_fn over matched points."""
    w = valid * torch.sqrt(Qk)
    sqrt_info = torch.cat(
        [(w / settings.sigma_ray).expand(-1, 3), w / settings.sigma_dist], dim=-1)
    rd_k = point_to_ray_dist(Xk)

    def residual_fn(T):
        Y = act_sim3(T, Xf)
        rd_f, drd_dX = point_to_ray_dist(Y, jacobian=True)
        return sqrt_info, rd_k - rd_f, -tau_jacobian(drd_dX, Y)

    return residual_fn


def _calib_problem(settings: GNSettings, Xf, Xk, Qk, valid, meas_k, valid_meas_k, K,
                   img_size):
    """The pixel + log-depth residual_fn; the border masks keep their shape."""
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

    return residual_fn


def _problem(mode: str, inputs, settings: GNSettings, img_size):
    if mode == "ray_dist":
        return _ray_dist_problem(settings, *inputs)
    return _calib_problem(settings, *inputs, img_size)


def tracking_gn_plain(mode: str, inputs, T_init, settings: GNSettings, img_size=None):
    """The eager frozen loop: ``mode`` "ray_dist" with inputs (Xf, Xk, Qk,
    valid), or "calib" with (Xf, Xk, Qk, valid, meas_k, valid_meas_k, K) and
    ``img_size``.  Returns (T, cost, ok, iterations)."""
    return _gn_loop(_problem(mode, inputs, settings, img_size), T_init, settings)


class _Pieces:
    """The loop's pieces over static inputs (the problem's inputs, then
    T_init): the prologue (the problem's set-up from the inputs, the loop
    state's initial values) and one iteration (the state updated in
    place), a ``gn_program.Program``'s captures."""

    def __init__(self, mode, inputs, settings: GNSettings, img_size):
        self.mode, self.settings, self.img_size = mode, settings, img_size
        self.inputs, self.T_init = inputs[:-1], inputs[-1]
        dev = self.T_init.device
        self.T = torch.empty_like(self.T_init)
        self.cost = torch.empty((), dtype=torch.float32, device=dev)
        self.ok = torch.empty((), dtype=torch.bool, device=dev)
        self.active = torch.empty((), dtype=torch.bool, device=dev)
        self.iters = torch.empty((), dtype=torch.int32, device=dev)
        self.loops = (gn_program.Loop(self.active, self.iters, settings.max_iters), None)
        self.residual_fn = None  # the prologue's

    def _problem(self):
        return _problem(self.mode, self.inputs, self.settings, self.img_size)

    def warm_up(self):
        _gn_step(self._problem(), self.T_init,
                 torch.full((), float("inf"), device=self.T.device), self.settings)

    def prologue(self):
        # its set-up tensors (weights, the keyframe's rays) live on with the
        # closure, which the iteration reads
        self.residual_fn = self._problem()
        self.T.copy_(self.T_init)
        self.cost.fill_(float("inf"))
        self.ok.fill_(True)
        self.active.fill_(True)
        self.iters.zero_()

    def body(self):
        T_new, cost_new, ok_new, converged = _gn_step(self.residual_fn, self.T, self.cost,
                                                       self.settings)
        self.T.copy_(T_new)
        self.cost.copy_(cost_new)
        self.ok.copy_(ok_new)
        torch.logical_and(~converged, ok_new, out=self.active)

    def parts(self):
        return (self.prologue, self.body)

    def outputs(self):
        return (self.T, self.cost, self.ok, self.iters)


_programs = gn_program.ProgramCache()


def tracking_gn_graph(mode: str, inputs, T_init, settings: GNSettings, img_size=None):
    """The loop on the card, ``tracking_gn_plain``'s results: the device
    program of (mode, input shapes, device, image size, settings), built at
    its first call (``gn_program``).  A build that fails raises."""
    if not T_init.is_cuda:
        raise ValueError("tracking_gn_graph runs on a CUDA device")
    if settings.max_iters < 1:  # the loop's first test fails: nothing runs
        return tracking_gn_plain(mode, inputs, T_init, settings, img_size)
    args = tuple(inputs) + (T_init,)
    key = (mode, tuple((a.shape, a.dtype) for a in inputs), T_init.device,
           tuple(img_size) if img_size is not None else None, settings)
    build = lambda: gn_program.Program(
        lambda static: _Pieces(mode, static, settings, img_size), args, counter)
    return _programs.run(key, build, args)


def _solve(mode, inputs, T_init, settings, img_size=None):
    if T_init.is_cuda:
        return tracking_gn_graph(mode, inputs, T_init, settings, img_size)[:3]
    return tracking_gn_plain(mode, inputs, T_init, settings, img_size)[:3]


def opt_pose_ray_dist_sim3(Xf, Xk, T_CkCf_init, Qk, valid, settings: GNSettings):
    """Uncalibrated ray + distance pose solve.

    Xf: (N, 3) matched frame points; Xk: (N, 3) keyframe points;
    T_CkCf_init: (8,); Qk: (N, 1) confidence; valid: (N, 1) float mask.
    Returns (T_CkCf (8,), cost, ok).
    """
    return _solve("ray_dist", (Xf, Xk, Qk, valid), T_CkCf_init, settings)


def opt_pose_calib_sim3(Xf, Xk, T_CkCf_init, Qk, valid, meas_k, valid_meas_k, K,
                        img_size, settings: GNSettings):
    """Calibrated pixel + log-depth pose solve.

    meas_k: (N, 3) [u, v, log z] keyframe measurements; valid_meas_k: (N, 1).
    """
    return _solve("calib", (Xf, Xk, Qk, valid, meas_k, valid_meas_k, K), T_CkCf_init,
                  settings, img_size)

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
settings) and launched on the caller's current stream: ``_GraphedGN``
captures one iteration in a CUDA graph and repeats it under a WHILE
conditional node (``csrc/gn_while.cu``), which stops after the last
active iteration, as the JAX ``while_loop`` does.

Residual models: ray + distance (uncalibrated, tracker.py:173-214) and
pixel + log-depth (calibrated, tracker.py:216-266).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..geometry import act_sim3, point_to_ray_dist, project_calib, tau_jacobian
from ..lie import sim3
from . import kernels
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


class _GraphedGN:
    """The loop as one device program (``csrc/gn_while.cu``): two captures
    over static buffers, the prologue (the problem's set-up from the inputs,
    the loop state's initial values) and one iteration (the state updated
    in place), joined into a graph whose WHILE node repeats the iteration
    while it is active.  A call copies its inputs in, launches the graph on
    the current stream and clones the outputs, so that two frames in flight
    never share them; a call from another stream first waits for the
    previous call's end."""

    def __init__(self, mode, inputs, T_init, settings: GNSettings, img_size):
        dev = T_init.device
        self.device = dev
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        with torch.cuda.device(dev):
            self.inputs = tuple(torch.empty_like(a) for a in inputs)
            self.T_init = torch.empty_like(T_init)
            self.T = torch.empty_like(T_init)
            self.cost = torch.empty((), dtype=torch.float32, device=dev)
            self.ok = torch.empty((), dtype=torch.bool, device=dev)
            self.active = torch.empty((), dtype=torch.bool, device=dev)
            self.iters = torch.empty((), dtype=torch.int32, device=dev)
            # one iteration on a side stream first: library handles and
            # workspaces exist before the captures
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._fill(inputs, T_init)
                _gn_step(_problem(mode, self.inputs, settings, img_size), self.T_init,
                         torch.full((), float("inf"), device=dev), settings)
            torch.cuda.current_stream(dev).wait_stream(side)
            # thread_local: the backend's worker may use the card meanwhile
            self.prologue = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.prologue, capture_error_mode="thread_local"):
                # its set-up tensors (weights, the keyframe's rays) live on
                # with the closure, which the iteration reads
                self.residual_fn = residual_fn = _problem(mode, self.inputs, settings,
                                                          img_size)
                self.T.copy_(self.T_init)
                self.cost.fill_(float("inf"))
                self.ok.fill_(True)
                self.active.fill_(True)
                self.iters.zero_()
            self.body = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.body, capture_error_mode="thread_local"):
                T_new, cost_new, ok_new, converged = _gn_step(residual_fn, self.T, self.cost,
                                                               settings)
                self.T.copy_(T_new)
                self.cost.copy_(cost_new)
                self.ok.copy_(ok_new)
                torch.logical_and(~converged, ok_new, out=self.active)
            exec_ = ctypes.c_void_p()
            kernels.check(kernels.entry_point("gn_while_build")(
                self.prologue.raw_cuda_graph(), self.body.raw_cuda_graph(),
                self.active.data_ptr(), self.iters.data_ptr(), settings.max_iters,
                ctypes.byref(exec_)), "gn_while_build")
            self.exec = exec_.value
            self.done.record(torch.cuda.current_stream(dev))

    def _fill(self, inputs, T_init):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.T_init.copy_(T_init)

    def __call__(self, inputs, T_init):
        with self.lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.done)
            self._fill(inputs, T_init)
            kernels.check(kernels.entry_point("gn_while_launch")(
                self.exec, stream.cuda_stream), "gn_while_launch")
            counter.add()
            out = tuple(a.clone() for a in (self.T, self.cost, self.ok, self.iters))
            self.done.record(stream)
        return out


_graphs: dict = {}
_graphs_lock = threading.Lock()


def tracking_gn_graph(mode: str, inputs, T_init, settings: GNSettings, img_size=None):
    """The loop on the card, ``tracking_gn_plain``'s results: the device
    program of (mode, input shapes, device, image size, settings), built at
    its first call.  A build that fails raises."""
    if not T_init.is_cuda:
        raise ValueError("tracking_gn_graph runs on a CUDA device")
    if settings.max_iters < 1:  # the loop's first test fails: nothing runs
        return tracking_gn_plain(mode, inputs, T_init, settings, img_size)
    key = (mode, tuple((a.shape, a.dtype) for a in inputs), T_init.device,
           tuple(img_size) if img_size is not None else None, settings)
    with _graphs_lock:
        graphed = _graphs.get(key)
        if graphed is None:
            graphed = _graphs[key] = _GraphedGN(mode, inputs, T_init, settings, img_size)
    return graphed(inputs, T_init)


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

"""Shared helpers of the port's parity tests (imported by tests/test_torch_*.py).

The same numpy float32 inputs, made from a seed, go through the JAX function
and its counterpart in ``mast3r_slam_tpu_torch``; results come back as numpy
and are compared with a tolerance each test states.  The port runs on the
CPU here (``device="cpu"``).
"""

from __future__ import annotations

import contextlib
import signal

import numpy as np
import torch

from mast3r_slam_tpu_torch.lie import sim3

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CPU = "cpu"


def t(x, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor, keeping the dtype unless given."""
    out = torch.from_numpy(np.array(x))  # a writable copy
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor (or JAX array) -> numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def f32(rng, *shape, scale=1.0) -> np.ndarray:
    return (rng.normal(size=shape) * scale).astype(np.float32)


def random_sim3(rng, batch=(), t_scale=1.0, rot_scale=1.0, s_range=(0.7, 1.4)):
    """Random Sim(3) 8-vectors [t, unit q (xyzw), s] as float32 numpy."""
    t_ = rng.normal(size=batch + (3,)) * t_scale
    q = rng.normal(size=batch + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    # keep rotations moderate: slerp toward identity by rot_scale
    q = (1 - rot_scale) * np.array([0, 0, 0, 1.0]) + rot_scale * q
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = rng.uniform(*s_range, size=batch + (1,))
    return np.concatenate([t_, q, s], axis=-1).astype(np.float32)


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise TimeoutError in the body after ``seconds`` of wall time
    (SIGALRM: tests run on their process's main thread)."""
    def fire(signum, frame):
        raise TimeoutError(f"over its time limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol, err_msg=what)


class TorchOracleModel:
    """Torch adapter around ``tests/oracle.OracleModel``: tensors in and out
    of the protocol (encode / asymmetric / symmetric / mono), numpy to the
    oracle."""

    def __init__(self, oracle, device=CPU):
        self.oracle = oracle
        self.device = torch.device(device)
        self.img_hw = oracle.img_hw
        self.feat_dim = oracle.feat_dim
        self.num_patches = oracle.num_patches

    def _t(self, x):
        return torch.as_tensor(np.array(x), device=self.device)

    def encode(self, img):
        feat, pos = self.oracle.encode(n(img))
        return self._t(feat), self._t(pos)

    def asymmetric(self, feat_i, pos_i, feat_j, pos_j):
        res_ii, res_ji = self.oracle.asymmetric(n(feat_i), n(pos_i), n(feat_j), n(pos_j))
        return (tuple(self._t(a) for a in res_ii), tuple(self._t(a) for a in res_ji))

    def symmetric(self, feat_i, pos_i, feat_j, pos_j):
        res = self.oracle.symmetric(n(feat_i), n(pos_i), n(feat_j), n(pos_j))
        return tuple(tuple(self._t(a) for a in r) for r in res)

    def mono(self, feat, pos):
        X, C = self.oracle.mono(n(feat), n(pos))
        return self._t(X), self._t(C)


def rays_problem(device, n_kf=5, N=3000, seed=0):
    """A shared world cloud seen through identity correspondences, chain
    edges both ways, perturbed poses (tests/test_sharded_ba.py's problem, on
    an arc of the port's own): (ground truth, gauss_newton_poses' leading
    arguments Twc ... K on ``device``, img_hw)."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0, 1, n_kf)
    gt = np.zeros((n_kf, 8), np.float32)
    gt[:, 0], gt[:, 1], gt[:, 2] = 0.4 * np.sin(2.4 * s), 0.2 * s, 0.3 * s
    gt[:, 4], gt[:, 6], gt[:, 7] = np.sin(-0.24 * s), np.cos(-0.24 * s), 1.0
    gt = torch.as_tensor(gt)
    world = torch.as_tensor(rng.uniform(-1, 1, size=(N, 3)) + [0, 0, 3], dtype=torch.float32)
    Xs = sim3.act(sim3.inv(gt)[:, None, :], world)
    ii = torch.tensor(list(range(n_kf - 1)) + list(range(1, n_kf)))
    jj = torch.tensor(list(range(1, n_kf)) + list(range(n_kf - 1)))
    E = len(ii)
    tau = torch.as_tensor(rng.normal(size=(n_kf, 7)) * 0.02, dtype=torch.float32)
    tau[0] = 0
    args = (sim3.retr(gt, tau), Xs, torch.full((n_kf, N, 1), 2.0), ii, jj,
            torch.arange(N, dtype=torch.int32).expand(E, N).contiguous(),
            torch.ones((E, N, 1), dtype=torch.bool), torch.full((E, N, 1), 2.0),
            torch.eye(3))
    return gt, [a.to(device) for a in args], (1, N)


def frozen_sharded(mesh, Twc, Xs, Cs, ii, jj, idx, valid, Q, K, hw, settings, mode):
    """The edge-sharded step under the plain frozen loop (``gn_loop`` without
    its early exit: ``max_iters`` steps): the bits both routes of
    ``gauss_newton_poses_sharded`` must give."""
    from mast3r_slam_tpu_torch.ops import global_gn
    from mast3r_slam_tpu_torch.parallel import sharded_ba as sb

    edges, K_r = sb._shard_fields(mesh, Xs, Cs, ii.long(), jj.long(), idx, valid, Q, K, hw,
                                  settings, mode)
    M = Twc.shape[0] - settings.pin

    def step(T, active):
        H, g, cost = sb._reduce(mesh, T, edges, K_r, hw, settings, mode)
        return sb._solve_dense(H, g, M, settings.pcg_damping) + (cost,)

    return global_gn.gn_loop(Twc.to(mesh.devices[0]), step, settings)

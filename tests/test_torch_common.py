"""Shared helpers of the port's parity tests (imported by tests/test_torch_*.py).

The same numpy float32 inputs, made from a seed, go through the JAX function
and its counterpart in ``mast3r_slam_tpu_torch``; results come back as numpy
and are compared with a tolerance each test states.  The port runs on the
CPU here (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

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


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol, err_msg=what)


class TorchOracleModel:
    """Torch adapter around ``tests/oracle.OracleModel``: tensors in and out
    of the protocol (encode / asymmetric / mono), numpy to the oracle."""

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

    def mono(self, feat, pos):
        X, C = self.oracle.mono(n(feat), n(pos))
        return self._t(X), self._t(C)

"""Exact-f32 norms (port of ``mast3r_slam_tpu/utils/numerics.py``).

An elementwise multiply and a sum, never a matrix product: on the card a
float32 product could run in TF32 if its switch were on, and the solvers'
scalars must not lose those digits.
"""

from __future__ import annotations

import torch


def vnorm(x: torch.Tensor, dim: int = -1, keepdim: bool = True) -> torch.Tensor:
    """L2 norm over ``dim`` as sqrt(sum(x*x))."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def vnormalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x||."""
    return x / vnorm(x, dim=dim, keepdim=True)

"""Exact-f32 norms (port of ``mast3r_slam_tpu/utils/numerics.py``).

An elementwise multiply and a sum, never a matrix product: on the card a
float32 product could run in TF32 if its switch were on, and the solvers'
scalars must not lose those digits.  Where a solver does need a matrix
product (the per-edge block reductions), ``full_f32`` turns TF32 off for
its duration.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run float32 matrix products on the card in full f32 (TF32 off),
    whatever the process-wide switch says, and restore it afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def index_add_fixed(dst: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst[index[k]] += src[k] along dim 0, in place, each slot summed in
    k's order on every device, so the same inputs give the same bits.
    ``index_put_`` with accumulate runs on CUDA as a stable sort by slot
    and a sequential reduction of each slot's run; ``index_add_`` there
    adds in atomic order, which changes from run to run."""
    return dst.index_put_((index,), src, accumulate=True)


def vnorm(x: torch.Tensor, dim: int = -1, keepdim: bool = True) -> torch.Tensor:
    """L2 norm over ``dim`` as sqrt(sum(x*x))."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def vnormalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x||."""
    return x / vnorm(x, dim=dim, keepdim=True)

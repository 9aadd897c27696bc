"""Robust IRLS weight (port of ``mast3r_slam_tpu/ops/robust.py``; the
tracker uses Huber only)."""

from __future__ import annotations

import torch


def huber_weight(r: torch.Tensor, k: float = 1.345) -> torch.Tensor:
    """1 inside |r| < k, k/|r| outside."""
    r_abs = r.abs()
    inside = r_abs < k
    r_safe = torch.where(inside, torch.full_like(r_abs, k), r_abs)
    return torch.where(inside, torch.ones_like(r_abs), k / r_safe)


"""Coarse-to-fine descriptor window argmax: the CUDA kernel and its plain form.

Port of ``mast3r_slam_tpu/ops/refine_pallas.py`` generalised to the whole of
``refine_matches(radius, dilation_max)`` and to the subset levels of
``refine_matches_gated`` (``mast3r_slam_tpu/ops/matching.py``): one launch
runs a short schedule of dilations in order, ``(dilation_max, ..., 1)`` for
``refine_matches`` and e.g. ``(5, 2)`` for the speed profile's subset.
Descriptors are quantised here, in torch, exactly as the JAX package does:
``clip(round(D * 127), -127, 127)`` to int8 (``torch.round`` rounds half to
even, like ``jnp.round``).  ``refine_window`` launches
``csrc/refine_window.cu`` on CUDA tensors or raises; on CPU tensors it runs
``refine_window_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

counter = kernels.LaunchCounter("refine_window")

_SCORE_MIN = torch.iinfo(torch.int32).min
MAX_FEATURES = 64  # the kernel keeps a descriptor in at most 16 registers
MAX_LEVELS = 8     # dilations a launch's schedule may hold (csrc MAX_LEVELS)


def quantize(D: torch.Tensor) -> torch.Tensor:
    """Unit descriptors -> int8, round half to even."""
    return torch.clamp(torch.round(D * 127.0), -127, 127).to(torch.int8)


def schedule(dilation_max: int) -> tuple:
    """The dilations of ``refine_matches(radius, dilation_max)``."""
    return tuple(range(dilation_max, 0, -1))


def _check_schedule(dilations) -> tuple:
    dilations = tuple(int(d) for d in dilations)
    if not 1 <= len(dilations) <= MAX_LEVELS or min(dilations) < 1:
        raise ValueError(f"refine: dilations {dilations}; a schedule holds 1 to "
                         f"{MAX_LEVELS} dilations, each >= 1")
    return dilations


def refine_window_plain(D11q, D21q, idx, H: int, W: int, radius: int, dilations):
    """D11q: (B, H*W, F) int8; D21q: (B, N, F) int8; idx: (B, N) int32 linear
    start indices, in any order; ``dilations``: the levels in the order they
    run.  Returns the refined (B, N) int32 linear indices."""
    B, HW, F = D11q.shape
    N = idx.shape[1]
    dev = idx.device
    diam = 2 * radius + 1
    doff = torch.arange(diam, device=dev, dtype=torch.int32) - radius
    d21 = D21q.to(torch.int32)[:, :, None, :]
    u0 = idx % W
    v0 = torch.div(idx, W, rounding_mode="floor")
    bidx = torch.arange(B, device=dev)[:, None, None]
    for d in _check_schedule(dilations):
        uu = u0[..., None] + doff * d          # (B, N, diam)
        vv = v0[..., None] + doff * d
        cu = uu[..., None, :].expand(B, N, diam, diam).reshape(B, N, -1)
        cv = vv[..., :, None].expand(B, N, diam, diam).reshape(B, N, -1)
        inside = (cu >= 0) & (cu < W) & (cv >= 0) & (cv < H)
        lin = torch.clamp(cv * W + cu, 0, HW - 1).long()
        rows = D11q[bidx, lin].to(torch.int32)  # (B, N, K, F)
        scores = torch.sum(rows * d21, dim=-1)
        scores = torch.where(inside, scores, torch.full_like(scores, _SCORE_MIN))
        k = torch.argmax(scores, dim=-1).to(torch.int32)  # first maximum
        u0 = u0 + (k % diam - radius) * d
        v0 = v0 + (torch.div(k, diam, rounding_mode="floor") - radius) * d
    return (v0 * W + u0).to(torch.int32)


def refine_window_cuda(D11q, D21q, idx, H: int, W: int, radius: int, dilations,
                       stats=None):
    """Launch the window-argmax kernel; raises on anything it does not take.

    ``stats``: None, or a zeroed (4,) int64 tensor on the card that the
    kernel adds to: (block, level) pairs served from the block's
    shared-memory window, all (block, level) pairs, pixel-levels served
    from a window, all pixel-levels."""
    for name, t, dt in (("D11q", D11q, torch.int8), ("D21q", D21q, torch.int8),
                        ("idx", idx, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"refine_window_cuda: {name} is not on a CUDA device")
        if t.dtype != dt:
            raise ValueError(f"refine_window_cuda: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"refine_window_cuda: {name} is not contiguous")
        if t.device != idx.device:
            raise ValueError("refine_window_cuda: inputs are on different devices")
        if dt == torch.int8 and t.data_ptr() % 8:  # rows read 4 or 8 bytes a load
            raise ValueError(f"refine_window_cuda: {name} is not 8-byte aligned")
    if D11q.ndim != 3 or D21q.ndim != 3 or idx.ndim != 2:
        raise ValueError("refine_window_cuda: expected D11q (B, H*W, F), "
                         "D21q (B, N, F), idx (B, N)")
    B, HW, F = D11q.shape
    N = idx.shape[1]
    if HW != H * W or D21q.shape != (B, N, F) or idx.shape[0] != B:
        raise ValueError(
            f"refine_window_cuda: shapes D11q {tuple(D11q.shape)}, D21q "
            f"{tuple(D21q.shape)}, idx {tuple(idx.shape)} do not agree with "
            f"H={H}, W={W}")
    if F % 4 != 0 or F > MAX_FEATURES:
        raise ValueError(
            f"refine_window_cuda: F={F}; the kernel takes F % 4 == 0 and "
            f"F <= {MAX_FEATURES}")
    if radius < 0:
        raise ValueError("refine_window_cuda: radius >= 0")
    dilations = _check_schedule(dilations)
    if stats is not None and (stats.shape != (4,) or stats.dtype != torch.int64
                              or stats.device != idx.device):
        raise ValueError("refine_window_cuda: stats must be a (4,) int64 tensor on "
                         "the inputs' device")
    out = torch.empty_like(idx)
    if B * N == 0:
        return out
    fn = kernels.entry_point("refine_window")
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = fn(D11q.data_ptr(), D21q.data_ptr(), idx.data_ptr(), out.data_ptr(),
                B, N, H, W, F, radius, (ctypes.c_int * len(dilations))(*dilations),
                len(dilations), None if stats is None else stats.data_ptr(), stream)
    kernels.check(rc, "refine_window_i8")
    counter.add()
    return out


def refine_window(D11q, D21q, idx, H: int, W: int, radius: int, dilations):
    """The window argmax on the tensors' device: kernel on CUDA, plain on CPU."""
    if idx.device.type == "cpu":
        return refine_window_plain(D11q, D21q, idx, H, W, radius, dilations)
    return refine_window_cuda(D11q, D21q, idx, H, W, radius, dilations)

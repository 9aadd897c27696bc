"""Coarse-to-fine descriptor window argmax: the CUDA kernel and its plain form.

Port of ``mast3r_slam_tpu/ops/refine_pallas.py`` generalised to the whole of
``refine_matches(radius, dilation_max)`` (``mast3r_slam_tpu/ops/matching.py``).
Descriptors are quantised here, in torch, exactly as the JAX package does:
``clip(round(D * 127), -127, 127)`` to int8 (``torch.round`` rounds half to
even, like ``jnp.round``).  ``refine_window`` launches
``csrc/refine_window.cu`` on CUDA tensors or raises; on CPU tensors it runs
``refine_window_plain``.
"""

from __future__ import annotations

import torch

from . import kernels

counter = kernels.LaunchCounter("refine_window")

_SCORE_MIN = torch.iinfo(torch.int32).min
MAX_FEATURES = 64  # the kernel keeps a descriptor in at most 16 registers


def quantize(D: torch.Tensor) -> torch.Tensor:
    """Unit descriptors -> int8, round half to even."""
    return torch.clamp(torch.round(D * 127.0), -127, 127).to(torch.int8)


def refine_window_plain(D11q, D21q, idx, H: int, W: int, radius: int,
                        dilation_max: int):
    """D11q: (B, H*W, F) int8; D21q: (B, N, F) int8; idx: (B, N) int32 linear
    start indices.  Returns the refined (B, N) int32 linear indices."""
    B, HW, F = D11q.shape
    N = idx.shape[1]
    dev = idx.device
    diam = 2 * radius + 1
    doff = torch.arange(diam, device=dev, dtype=torch.int32) - radius
    d21 = D21q.to(torch.int32)[:, :, None, :]
    u0 = idx % W
    v0 = torch.div(idx, W, rounding_mode="floor")
    bidx = torch.arange(B, device=dev)[:, None, None]
    for d in range(dilation_max, 0, -1):
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


def refine_window_cuda(D11q, D21q, idx, H: int, W: int, radius: int,
                       dilation_max: int):
    """Launch the window-argmax kernel; raises on anything it does not take."""
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
    if radius < 0 or dilation_max < 1:
        raise ValueError("refine_window_cuda: radius >= 0 and dilation_max >= 1")
    out = torch.empty_like(idx)
    if B * N == 0:
        return out
    fn = kernels.entry_point("refine_window")
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = fn(D11q.data_ptr(), D21q.data_ptr(), idx.data_ptr(), out.data_ptr(),
                B, N, H, W, F, radius, dilation_max, stream)
    kernels.check(rc, "refine_window_i8")
    counter.count += 1
    return out


def refine_window(D11q, D21q, idx, H: int, W: int, radius: int,
                  dilation_max: int):
    """The window argmax on the tensors' device: kernel on CUDA, plain on CPU."""
    if idx.device.type == "cpu":
        return refine_window_plain(D11q, D21q, idx, H, W, radius, dilation_max)
    return refine_window_cuda(D11q, D21q, idx, H, W, radius, dilation_max)

"""Scaled-dot-product attention: the hand-written CUDA kernel and its plain form.

Port of ``mast3r_slam_tpu/ops/attention.py``.  ``sdpa`` is the one attention
of the port.  On a CUDA tensor it launches ``csrc/attention.cu`` (bf16, head
dim 64; wgmma with TMA loads) or raises; on a CPU tensor it runs
``sdpa_plain``, the same function as ``sdpa_xla`` in the JAX package: f32
logits, max-subtracted f32 softmax, weights cast to v's dtype, then the PV
product.

q, k and v may be strided views (heads split from a fused projection
without a copy): the kernel takes unit stride on D and any other strides
that are multiples of 16 bytes.  On the card the output is written in
(B, N, H, D) memory order and returned as a (B, H, N, D) view, so merging
the heads afterwards is a view too.
"""

from __future__ import annotations

import torch

from . import kernels

counter = kernels.LaunchCounter("attention")

HEAD_DIM = 64
_ALIGN = 8  # elements: TMA takes strides and addresses in multiples of 16 bytes


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, H, N, D), k/v: (B, H, M, D) -> (B, H, N, D) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    w = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def _strides(name: str, t: torch.Tensor):
    """(batch, head, row) element strides the kernel's tensor maps take; a
    dimension of size 1 is never stepped, so it gets the stride of a packed
    tensor of its size, which the map accepts whatever torch reports."""
    if t.stride(-1) != 1:
        raise ValueError(f"sdpa_cuda: {name} has stride {t.stride(-1)} on D, the kernel "
                         f"takes D contiguous")
    out = []
    for dim in (0, 1, 2):
        s = t.stride(dim) if t.shape[dim] > 1 else -(-t.numel() // _ALIGN) * _ALIGN
        if s <= 0 or s % _ALIGN:
            raise ValueError(
                f"sdpa_cuda: {name} has strides {t.stride()}; the kernel takes strides "
                f"that are positive multiples of {_ALIGN} elements (16 bytes)")
        out.append(s)
    return out


def sdpa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the attention kernel; raises on anything it does not take."""
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"sdpa_cuda: {name} is not on a CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"sdpa_cuda: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.ndim != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(
                f"sdpa_cuda: {name} has shape {tuple(t.shape)}, the kernel "
                f"takes (B, H, N, {HEAD_DIM})")
        if t.device != q.device:
            raise ValueError("sdpa_cuda: q, k, v are on different devices")
        if t.data_ptr() % 16:  # TMA reads from 16-byte aligned addresses
            raise ValueError(f"sdpa_cuda: {name} is not 16-byte aligned")
        strides += _strides(name, t)
    B, H, N, _ = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, HEAD_DIM) or v.shape != k.shape:
        raise ValueError(
            f"sdpa_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree")
    out = torch.empty((B, N, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    if N == 0 or B * H == 0:
        return out.transpose(1, 2)
    if M == 0:
        raise ValueError("sdpa_cuda: no keys")
    fn = kernels.entry_point("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, N, M, *strides, HEAD_DIM ** -0.5, stream)
    kernels.check(rc, "attention_bf16_d64")
    counter.add()
    return out.transpose(1, 2)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on the tensors' device: the kernel on CUDA, the plain form on CPU."""
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v)
    return sdpa_cuda(q, k, v)

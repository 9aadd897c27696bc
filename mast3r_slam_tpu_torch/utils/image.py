"""Scharr gradients and the host resize geometry.

Port of ``mast3r_slam_tpu/utils/image.py``: the 3x3 Scharr kernel /32 with
reflect padding, written as shifted slices and adds, in either layout; and
``resize_geometry``, the resize and crop of ``resize_img``, which the host
library (``utils/native.py``, at 512) and PIL (``utils/pil_image.py``, at
other sizes) apply.
"""

from __future__ import annotations

import torch


def _reflect_index(n: int, device) -> torch.Tensor:
    """Indices of a reflect pad by 1: [1, 0, 1, ..., n-2, n-1, n-2]."""
    idx = torch.arange(-1, n + 1, device=device)
    idx = idx.abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _scharr(img: torch.Tensor, h_dim: int, w_dim: int):
    h_dim %= img.ndim
    w_dim %= img.ndim
    n_h, n_w = img.shape[h_dim], img.shape[w_dim]
    p = img.index_select(h_dim, _reflect_index(n_h, img.device))
    p = p.index_select(w_dim, _reflect_index(n_w, img.device))

    def sl(dy, dx):
        return p.narrow(h_dim, dy, n_h).narrow(w_dim, dx, n_w)

    tl, tc, tr = sl(0, 0), sl(0, 1), sl(0, 2)
    ml, mr = sl(1, 0), sl(1, 2)
    bl, bc, br = sl(2, 0), sl(2, 1), sl(2, 2)
    k = 1.0 / 32.0
    gx = k * (3.0 * (tr - tl) + 10.0 * (mr - ml) + 3.0 * (br - bl))
    gy = k * (3.0 * (bl - tl) + 10.0 * (bc - tc) + 3.0 * (br - tr))
    return gx, gy


def img_gradient_nhwc(img: torch.Tensor):
    """Scharr x/y gradients of (..., H, W, C) -> (gx, gy), same shape."""
    return _scharr(img, -3, -2)


def resize_geometry(W1: int, H1: int, size: int = 512, square_ok: bool = False):
    """The resize and crop that ``resize_img`` applies to a W1 x H1 image:
    ((W, H) after the resize, (x0, y0, x1, y1) the crop box in it).  The
    long side goes to ``size`` (224: the short side, then a centred
    square); the crop keeps H and W multiples of 16 (a square image keeps
    a 4:3 crop unless ``square_ok``)."""
    if not (size == 224 or (size >= 16 and size % 16 == 0)):
        raise ValueError(f"resize target {size} must be 224 or a multiple of 16")
    long_edge = max(W1, H1)
    target = round(size * max(W1 / H1, H1 / W1)) if size == 224 else size
    scale = target / long_edge
    W, H = int(round(W1 * scale)), int(round(H1 * scale))
    cx, cy = W // 2, H // 2
    if size == 224:
        halfw = halfh = min(cx, cy)
    else:
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if not square_ok and W == H:
            halfh = int(3 * halfw / 4)
    return (W, H), (cx - halfw, cy - halfh, cx + halfw, cy + halfh)

"""Scharr gradients and the host resize pipeline.

Port of ``mast3r_slam_tpu/utils/image.py``: the 3x3 Scharr kernel /32 with
reflect padding, written as shifted slices and adds, in either layout.
"""

from __future__ import annotations

import numpy as np
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


def resize_img(img: np.ndarray, size: int = 512, square_ok: bool = False):
    """Resize the long side to ``size`` and crop H, W to multiples of 16.

    img: float array (H, W, 3) in [0, 1].  Returns a dict with
      img: (3, h, w) float32 normalised to [-1, 1]
      true_shape: (1, 2) int32 [h, w]
      unnormalized_img: (h, w, 3) uint8
    PIL is imported here, not at module import: a caller that feeds
    preprocessed frames needs no PIL.
    """
    import PIL.Image

    if not (size == 224 or (size >= 16 and size % 16 == 0)):
        raise ValueError(f"resize target {size} must be 224 or a multiple of 16")
    pil = PIL.Image.fromarray(np.uint8(np.clip(img, 0, 1) * 255))
    W1, H1 = pil.size
    long_edge = max(W1, H1)
    if size == 224:
        target = round(size * max(W1 / H1, H1 / W1))
    else:
        target = size
    interp = PIL.Image.LANCZOS if long_edge > target else PIL.Image.BICUBIC
    scale = target / long_edge
    pil = pil.resize((int(round(W1 * scale)), int(round(H1 * scale))), interp)

    W, H = pil.size
    cx, cy = W // 2, H // 2
    if size == 224:
        half = min(cx, cy)
        pil = pil.crop((cx - half, cy - half, cx + half, cy + half))
    else:
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if not square_ok and W == H:
            halfh = int(3 * halfw / 4)
        pil = pil.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))

    arr = np.asarray(pil)
    norm = (arr.astype(np.float32) / 255.0 - 0.5) / 0.5
    return dict(
        img=np.transpose(norm, (2, 0, 1)),
        true_shape=np.int32([[pil.size[1], pil.size[0]]]),
        unnormalized_img=arr,
    )

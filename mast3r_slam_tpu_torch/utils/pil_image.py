"""The PIL resize of ``mast3r_slam_tpu/utils/image.py`` ``resize_img``, for
the sizes other than 512 (the engine resizes to 512 with the host library,
``utils/native.py``, and loads this module only for another size).
"""

from __future__ import annotations

import numpy as np

from .image import resize_geometry


def resize_img(img: np.ndarray, size: int = 512, square_ok: bool = False):
    """Resize the long side to ``size`` and crop H, W to multiples of 16.

    img: float array (H, W, 3) in [0, 1].  Returns a dict with
      img: (3, h, w) float32 normalised to [-1, 1]
      true_shape: (1, 2) int32 [h, w]
      unnormalized_img: (h, w, 3) uint8
    PIL is imported here: no module of the port imports it at import.
    """
    import PIL.Image

    pil = PIL.Image.fromarray(np.uint8(np.clip(img, 0, 1) * 255))
    W1, H1 = pil.size
    (W, H), box = resize_geometry(W1, H1, size, square_ok)
    interp = PIL.Image.LANCZOS if max(W1, H1) > max(W, H) else PIL.Image.BICUBIC
    pil = pil.resize((W, H), interp).crop(box)

    arr = np.asarray(pil)
    norm = (arr.astype(np.float32) / 255.0 - 0.5) / 0.5
    return dict(
        img=np.transpose(norm, (2, 0, 1)),
        true_shape=np.int32([[pil.size[1], pil.size[0]]]),
        unnormalized_img=arr,
    )

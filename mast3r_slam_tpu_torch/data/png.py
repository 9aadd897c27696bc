"""PNG files without cv2 or PIL.

The card's machine has neither, and the TUM, 7-Scenes, ETH3D and EuRoC
sequences are PNGs.  ``read_png`` reads 8-bit, non-interlaced gray, RGB
and RGBA files into the arrays ``cv2.imread`` gives (channels in file
order: RGB, not cv2's BGR); ``zlib`` inflates the image data and the host
library (``utils/native.py``) undoes the five row filters.  ``imread_rgb``
and ``imread_gray`` are the dataset loaders' reads: a PNG through
``read_png``, any other file (a JPEG) through ``data/cv2_io.py``, loaded
only then.  ``write_png`` writes RGB images with filter 0.  Palette,
16-bit and interlaced files raise ``ValueError``.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (gray, RGB, RGBA)


def _chunks(data: bytes, path):
    at = len(SIGNATURE)
    while at + 12 <= len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind = data[at + 4:at + 8]
        body = data[at + 8:at + 8 + n]
        (crc,) = struct.unpack(">I", data[at + 8 + n:at + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r} at byte {at}")
        yield kind, body
        if kind == b"IEND":
            return
        at += 12 + n
    raise ValueError(f"{path}: PNG ends without IEND")


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8 as stored: C = 1 (gray), 3 (RGB) or 4 (RGBA)."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}; only 8-bit non-interlaced gray, RGB "
                         "and RGBA are read")
    from ..utils.native import png_unfilter

    C = _CHANNELS[ctype]
    rows = png_unfilter(zlib.decompress(b"".join(idat)), H, W * C, C)
    return rows.reshape(H, W, C)


def imread_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``cv2.cvtColor(cv2.imread(path), BGR2RGB)``:
    gray replicated, alpha dropped."""
    if pathlib.Path(path).suffix.lower() != ".png":
        from . import cv2_io

        return cv2_io.imread_rgb(path)
    img = read_png(path)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread_gray(path) -> np.ndarray:
    """(H, W) uint8 of a gray image (``cv2.imread(path, IMREAD_GRAYSCALE)``
    on a gray file); a colour PNG raises."""
    if pathlib.Path(path).suffix.lower() != ".png":
        from . import cv2_io

        return cv2_io.imread_gray(path)
    img = read_png(path)
    if img.shape[2] != 1:
        raise ValueError(f"{path}: a {img.shape[2]}-channel PNG where a gray one is read")
    return img[..., 0]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image, every row with filter 0."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    H, W = rgb.shape[:2]
    raw = np.zeros((H, 1 + 3 * W), dtype=np.uint8)
    raw[:, 1:] = rgb.reshape(H, 3 * W)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(SIGNATURE
                     + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                     + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                     + _chunk(b"IEND", b""))

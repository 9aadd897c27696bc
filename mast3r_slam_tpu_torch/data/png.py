"""Image files without cv2 or PIL.

The card's machine has neither, and the TUM, 7-Scenes, ETH3D and EuRoC
sequences are PNGs, image folders JPEGs.  ``read_png`` reads every PNG that
``cv2.imread`` reads: gray, RGB, palette, gray+alpha and RGBA, at each bit
depth the PNG specification allows for its colour type (1, 2, 4, 8, 16),
interlaced (Adam7) or not, into 8-bit samples as cv2 makes them (16 bits
by their high byte, 1, 2 and 4-bit gray scaled to 0-255, the palette
expanded to RGB); ``tRNS`` is read past, as ``IMREAD_COLOR`` drops alpha.
``decode_png`` does the same from bytes (the session server's payloads);
``zlib`` inflates the image data and the host library
(``utils/native.py``) undoes the five row filters.

``imread_rgb`` and ``imread_gray`` are the dataset loaders' reads.  They
tell the format by the file's first bytes, as cv2 does, not by its
suffix: a PNG through ``decode_png``, a JPEG through the host library's
decoder (``utils/native.decode_jpeg``, EXIF orientation applied as
``cv2.imread`` applies it), never through cv2, so that the port's pixels
do not depend on whether cv2 is installed; any other file through
``data/cv2_io.py``, loaded only then.  ``write_png`` writes RGB images
with filter 0, ``encode_png`` returns the same bytes.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"
# colour type -> (samples a pixel as stored, the bit depths the specification allows)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes, path):
    at = len(SIGNATURE)
    while at + 12 <= len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind = data[at + 4:at + 8]
        if at + 12 + n > len(data):
            raise ValueError(f"{path}: PNG chunk {kind!r} at byte {at} is cut short")
        body = data[at + 8:at + 8 + n]
        (crc,) = struct.unpack(">I", data[at + 8 + n:at + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r} at byte {at}")
        yield kind, body
        if kind == b"IEND":
            return
        at += 12 + n
    raise ValueError(f"{path}: PNG ends without IEND")


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8: C = 1 (gray), 2 (gray+alpha), 3 (RGB, palette) or
    4 (RGBA), channels in file order (not cv2's BGR)."""
    return decode_png(pathlib.Path(path).read_bytes(), path)


def _row_bytes(width: int, bits: int) -> int:
    return (width * bits + 7) // 8


def _samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """The first ``n`` samples of each unfiltered row, as stored (below 8
    bits unpacked, most significant first; 16 bits by the high byte)."""
    if depth == 16:
        return rows[:, 0:2 * n:2]
    if depth == 8:
        return rows[:, :n]
    bits = np.unpackbits(rows, axis=1)
    bits = bits[:, :n * depth].reshape(rows.shape[0], n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def decode_png(data: bytes, path="PNG data") -> np.ndarray:
    """``read_png`` of a file's bytes; ``path`` names them in errors.  A
    colour type and bit depth the specification forbids, a palette image
    without ``PLTE``, a corrupt chunk, an image over
    ``utils.native.MAX_PIXELS`` or image data that does not inflate to its
    rows raises ``ValueError``, before more than the rows are inflated."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: PNG IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, compression, filtering, interlace = header
    if (ctype not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[ctype][1]
            or compression != 0 or filtering != 0 or interlace > 1):
        raise ValueError(f"{path}: PNG bit depth {depth}, colour type {ctype}, compression "
                         f"{compression}, filter method {filtering}, interlace {interlace}: "
                         "the PNG specification allows no such image")
    if W == 0 or H == 0:
        raise ValueError(f"{path}: a {W}x{H} PNG")
    if ctype == 3 and (palette is None or len(palette) % 3 or not 3 <= len(palette) <= 768):
        raise ValueError(f"{path}: a palette PNG without a valid PLTE chunk")
    from ..utils.native import MAX_PIXELS, png_unfilter

    if W * H > MAX_PIXELS:
        raise ValueError(f"{path}: a {W}x{H} PNG exceeds the limit of {MAX_PIXELS} pixels")
    C = _COLOUR_TYPES[ctype][0]
    bits = C * depth
    bpp = max(1, bits // 8)  # the filters' byte distance
    passes = ([(x0, y0, dx, dy, (W - x0 + dx - 1) // dx, (H - y0 + dy - 1) // dy)
               for x0, y0, dx, dy in _ADAM7] if interlace else [(0, 0, 1, 1, W, H)])
    passes = [p for p in passes if p[4] and p[5]]
    total = sum(ph * (_row_bytes(pw, bits) + 1) for *_, pw, ph in passes)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), total)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if len(raw) != total:
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, expected {total}")
    img = np.empty((H, W, C), np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes:
        n = ph * (_row_bytes(pw, bits) + 1)
        rows = png_unfilter(raw[at:at + n], ph, _row_bytes(pw, bits), bpp)
        at += n
        img[y0::dy, x0::dx] = _samples(rows, pw * C, depth).reshape(ph, pw, C)
    if depth < 8 and ctype == 0:  # libpng's expansion of low-depth gray
        img *= 255 // ((1 << depth) - 1)
    if ctype == 3:  # indices past the palette read black, as libpng reads them
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette) // 3] = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        img = lut[img[..., 0]]
    return img


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB of ``read_png``'s result, as
    ``cv2.imread(..., IMREAD_COLOR)`` makes it: gray replicated, alpha
    dropped."""
    if img.shape[2] <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``cv2.cvtColor(cv2.imread(path), BGR2RGB)``:
    gray replicated, alpha dropped, a JPEG's EXIF orientation applied."""
    data = pathlib.Path(path).read_bytes()
    if data.startswith(SIGNATURE):
        return to_rgb(decode_png(data, path))
    if data.startswith(JPEG_MAGIC):
        from ..utils.native import decode_jpeg

        return decode_jpeg(data)
    from . import cv2_io

    return cv2_io.imread_rgb(path)


def imread_gray(path) -> np.ndarray:
    """(H, W) uint8 of a gray image (``cv2.imread(path, IMREAD_GRAYSCALE)``
    on a gray file: a gray or gray+alpha PNG, a one-component JPEG); a
    colour PNG or JPEG raises ``ValueError`` (cv2 would convert it;
    ROADMAP Queue 1 item 15)."""
    data = pathlib.Path(path).read_bytes()
    if data.startswith(SIGNATURE):
        img = decode_png(data, path)
        kind = f"a {img.shape[2]}-channel PNG"
    elif data.startswith(JPEG_MAGIC):
        from ..utils.native import decode_jpeg, jpeg_info

        if jpeg_info(data)["components"] == 1:
            return decode_jpeg(data)[..., 0].copy()
        img, kind = None, "a colour JPEG"
    else:
        from . import cv2_io

        return cv2_io.imread_gray(path)
    if img is None or img.shape[2] > 2:
        raise ValueError(f"{path}: {kind} where a gray one is read (the conversion to gray "
                         "is ROADMAP Queue 1 item 15)")
    return img[..., 0].copy()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(rgb: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) uint8 RGB image, every row with filter 0."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    H, W = rgb.shape[:2]
    raw = np.zeros((H, 1 + 3 * W), dtype=np.uint8)
    raw[:, 1:] = rgb.reshape(H, 3 * W)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image (``encode_png``)."""
    data = encode_png(rgb)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)

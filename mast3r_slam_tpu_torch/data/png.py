"""Image files without cv2 or PIL.

The card's machine has neither, and the TUM, 7-Scenes, ETH3D and EuRoC
sequences are PNGs, image folders JPEGs.  ``read_png`` reads every PNG that
``cv2.imread`` reads: gray, RGB, palette, gray+alpha and RGBA, at each bit
depth the PNG specification allows for its colour type (1, 2, 4, 8, 16),
interlaced (Adam7) or not, into 8-bit samples as cv2 makes them (16 bits
by their high byte, 1, 2 and 4-bit gray scaled to 0-255, the palette
expanded to RGB); ``tRNS`` is read past, as ``IMREAD_COLOR`` drops alpha.
``decode_png`` does the same from bytes (the session server's payloads),
and with ``gray`` gives ``IMREAD_GRAYSCALE``'s image: colour converted by
libpng's ``rgb_to_gray`` at cv2's weights; ``zlib`` inflates the image
data and the host library (``utils/native.py``) undoes the five row
filters.

``imread_rgb`` and ``imread_gray`` are the dataset loaders' reads
(``cv2.imread`` with ``IMREAD_COLOR``, in RGB order, and with
``IMREAD_GRAYSCALE``).  They tell the format by the file's first bytes, as
cv2 does, not by its suffix: a PNG through ``decode_png``, a JPEG through
the host library's decoder (``utils/native.decode_jpeg``, EXIF orientation
applied as ``cv2.imread`` applies it), never through cv2, so that the
port's pixels do not depend on whether cv2 is installed; any other file
through ``data/cv2_io.py``, loaded only then.  ``write_png`` writes RGB images
with filter 0, ``encode_png`` returns the same bytes.
"""

from __future__ import annotations

import functools
import math
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
    bits unpacked, most significant first; 16 bits as uint16)."""
    if depth == 16:
        return (rows[:, 0:2 * n:2].astype(np.uint16) << 8) | rows[:, 1:2 * n:2]
    if depth == 8:
        return rows[:, :n]
    bits = np.unpackbits(rows, axis=1)
    bits = bits[:, :n * depth].reshape(rows.shape[0], n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def decode_png(data: bytes, path="PNG data", gray: bool = False) -> np.ndarray:
    """``read_png`` of a file's bytes; ``path`` names them in errors.  With
    ``gray``, (H, W) uint8 as ``cv2.imdecode(..., IMREAD_GRAYSCALE)`` gives
    it (``_to_gray``).  A colour type and bit depth the specification
    forbids, a palette image without ``PLTE``, a corrupt chunk, an image
    over ``utils.native.MAX_PIXELS`` or image data that does not inflate to
    its rows raises ``ValueError``, before more than the rows are
    inflated."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat, gamma, srgb, sbit = None, None, [], None, False, 0
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: PNG IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif palette is not None or idat:
            continue  # libpng ignores a gAMA, sRGB or sBIT after PLTE or IDAT
        elif kind == b"gAMA" and len(body) == 4 and gamma is None:
            gamma = struct.unpack(">I", body)[0]
            gamma = gamma if 0 < gamma < 1 << 31 else None
        elif kind == b"sRGB" and len(body) == 1 and body[0] < 4:
            srgb = True
        elif kind == b"sBIT" and header is not None and header[3] in _COLOUR_TYPES:
            sample_depth = 8 if header[3] == 3 else header[2]
            if (len(body) == (3 if header[3] == 3 else _COLOUR_TYPES[header[3]][0])
                    and all(0 < v <= sample_depth for v in body)):
                sbit = max(body[:3])
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
    img = np.empty((H, W, C), np.uint16 if depth == 16 else np.uint8)
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
    if gray:
        return _to_gray(img, _SRGB_GAMMA if srgb else gamma, sbit)
    return (img >> 8).astype(np.uint8) if depth == 16 else img


# libpng's fixed-point gammas (1.0 is 100000): sRGB's, and the band around
# 1.0 inside which a gamma is not significant
_FP1 = 100000
_SRGB_GAMMA = 45455


def _significant(g: int) -> bool:
    return g < _FP1 - 5000 or g > _FP1 + 5000


def _reciprocal(a: int) -> int:
    return math.floor(1e10 / a + 0.5)


@functools.lru_cache(maxsize=16)
def _gamma_8(g: int) -> np.ndarray:
    """png_build_8bit_table: 255 (i / 255) ** g, rounded; identity if g is
    not significant."""
    t = np.arange(256, dtype=np.int64)
    if _significant(g):
        t[1:255] = [math.floor(255 * math.pow(i / 255.0, g * 1e-5) + 0.5) for i in range(1, 255)]
    return t


def _gamma_shift(sbit: int) -> int:
    """The low bits libpng's 16-bit gamma tables drop: those an ``sBIT``
    chunk calls insignificant, at least 5 when the output is 8-bit (11
    bits kept), at most 8."""
    shift = 16 - sbit if 0 < sbit < 16 else 0
    return min(max(shift, 5), 8)


@functools.lru_cache(maxsize=16)
def _gamma_16(g: int, shift: int) -> np.ndarray:
    """png_build_16bit_table, indexed by a sample's top 16 - shift bits."""
    top = (1 << (16 - shift)) - 1
    i = np.arange(top + 1, dtype=np.int64)
    if not _significant(g):
        return (i * 65535 + (1 << (15 - shift))) // top
    return np.array([math.floor(65535.0 * math.pow(x * (1.0 / top), g * 1e-5) + 0.5)
                     for x in range(top + 1)], np.int64)


@functools.lru_cache(maxsize=16)
def _gamma_16_to_8(g: int, shift: int) -> np.ndarray:
    """png_build_16to8_table, indexed by a sample's top 16 - shift bits:
    each 8-bit output o (as o * 257) up to the input where g's curve
    crosses o + 1/2."""
    top = (1 << (16 - shift)) - 1
    table = np.full(top + 1, 65535, np.int64)
    last = 0
    for o in range(255):
        v = o * 257 + 128
        bound = (math.floor(65535 * math.pow(v / 65535.0, g * 1e-5) + 0.5) * top
                 + 32768) // 65535 + 1
        table[last:bound] = o * 257
        last = max(last, bound)
    return table


def _to_gray(img: np.ndarray, file_gamma=None, sbit=0) -> np.ndarray:
    """(H, W) uint8 of decoded samples (uint16 at 16 bits), as cv2's
    ``IMREAD_GRAYSCALE`` has libpng make it: alpha dropped, colour by
    ``png_set_rgb_to_gray(0.299, 0.587)`` (integer weights 9797, 19234 and
    3737 over 2**15), 16 bits then cut to the high byte.  Without a
    significant file gamma (``gAMA``, or ``sRGB``'s 0.45455) the weighted
    sum truncates at 8 bits and rounds at 16.  With one, libpng takes the
    screen gamma as its reciprocal and weighs linear light: each sample
    through its to-linear table, the rounded sum back through the
    from-linear one (16-bit tables at 11 bits, fewer under ``sBIT``), and a
    pixel whose three samples are equal through the file-to-screen table."""
    if img.shape[2] <= 2:
        y = img[..., 0]
        return (y >> 8 if img.dtype == np.uint16 else y).astype(np.uint8)
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    sixteen = img.dtype == np.uint16
    screen = None if file_gamma is None else _reciprocal(file_gamma)
    if screen is None or not (_significant(file_gamma) or _significant(screen)):
        y = 9797 * r + 19234 * g + 3737 * b
        y = (y + 16384) >> 15 if sixteen else y >> 15
        return (y >> 8 if sixteen else y).astype(np.uint8)
    to_1, from_1 = _reciprocal(file_gamma), _reciprocal(screen)
    equal = (r == g) & (r == b)
    if sixteen:
        s = _gamma_shift(sbit)
        lin = _gamma_16(to_1, s)
        y = (9797 * lin[r >> s] + 19234 * lin[g >> s] + 3737 * lin[b >> s] + 16384) >> 15
        product = math.floor(file_gamma * 1e-5 * screen + 0.5)
        y = np.where(equal, _gamma_16_to_8(product, s)[r >> s], _gamma_16(from_1, s)[y >> s])
        return (y >> 8).astype(np.uint8)
    lin = _gamma_8(to_1)
    y = _gamma_8(from_1)[(9797 * lin[r] + 19234 * lin[g] + 3737 * lin[b] + 16384) >> 15]
    same = _gamma_8(math.floor(1e15 / file_gamma / screen + 0.5))
    return np.where(equal, same[r], y).astype(np.uint8)


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
    """(H, W) uint8, as ``cv2.imread(path, IMREAD_GRAYSCALE)``: a colour
    PNG converted by libpng's weights, a JPEG read as libjpeg reads it to
    gray (the Y plane of YCbCr) and OpenCV converts CMYK, a JPEG's EXIF
    orientation applied."""
    data = pathlib.Path(path).read_bytes()
    if data.startswith(SIGNATURE):
        return decode_png(data, path, gray=True)
    if data.startswith(JPEG_MAGIC):
        from ..utils.native import decode_jpeg

        return decode_jpeg(data, gray=True)
    from . import cv2_io

    return cv2_io.imread_gray(path)


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

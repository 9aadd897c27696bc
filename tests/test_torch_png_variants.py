"""Every PNG that ``cv2.imread(..., IMREAD_COLOR)`` reads, through the
port's reader (``mast3r_slam_tpu_torch/data/png.py``) and the session
server's payload decoder, exactly against cv2 (libpng): each colour type at
each bit depth the PNG specification allows, Adam7 interlace, odd sizes,
``tRNS`` present or not, and every file against ``IMREAD_GRAYSCALE`` too
(colour converted by libpng's ``rgb_to_gray`` at cv2's weights).

cv2 writes none of palette, sub-byte, gray+alpha or interlaced PNGs, so
the files come from the small writer below (the specification's filters,
each row under one of the five, the image data split over two IDATs).
"""

import base64
import struct
import zlib

import cv2
import numpy as np
import pytest

from mast3r_slam_tpu.serve import server as jserver
from mast3r_slam_tpu_torch.data import png
from mast3r_slam_tpu_torch.serve import server

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
NAMES = {0: "gray", 2: "rgb", 3: "palette", 4: "gray-alpha", 6: "rgba"}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples, depth):
    """(h, n) samples -> (h, row bytes): big-endian at 16 bits, packed most
    significant first below 8."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, n * depth), axis=1)


def _filter(rows, bpp, row):
    """Rows under filters 4, 3, 2, 1, 0 in turn, starting at ``row``."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for r in range(rows.shape[0]):
        cur = rows[r].astype(np.int64)
        f = (4, 3, 2, 1, 0)[(row + r) % 5]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:len(cur)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(cur)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(f)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def write_png(samples, ctype, depth, interlace=0, palette=None, trns=None):
    """The PNG file of (H, W, C) samples as stored."""
    H, W, C = samples.shape
    bpp = max(1, C * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, y0)
    data = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0,
                                                       interlace))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    z = zlib.compress(raw, 6)
    return (data + _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
            + _chunk(b"IEND", b""))


def variant(ctype, depth, interlace, hw, trns, seed=0):
    """A random image of the colour type and depth; a palette of fewer
    entries than the depth indexes, some pixels past it (libpng reads them
    black); ``tRNS`` of the type's own form."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    palette = t = None
    if ctype == 3:
        n = max(1, min(200, top))
        palette = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, min(n + 1, top + 1), hw + (1,))
        if trns:
            t = bytes(rng.integers(0, 256, min(n, 5)).astype(np.uint8))
    else:
        samples = rng.integers(0, top + 1, hw + (CHANNELS[ctype],))
        if trns:
            t = struct.pack(">" + "H" * CHANNELS[ctype], *map(int, samples[0, 0]))
    return write_png(samples, ctype, depth, interlace, palette, t)


def _cv2(data, flag=cv2.IMREAD_COLOR):
    out = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    assert out is not None
    return cv2.cvtColor(out, cv2.COLOR_BGR2RGB) if flag == cv2.IMREAD_COLOR else out


CASES = [(c, d, i, hw, t) for c, ds in DEPTHS.items() for d in ds for i in (0, 1)
         for hw in ((1, 1), (3, 2), (9, 17), (37, 53)) for t in (False, True)
         if not (t and c in (4, 6))]  # tRNS is forbidden where alpha is stored


@pytest.mark.parametrize("ctype,depth,interlace,hw,trns", CASES,
                         ids=[f"{NAMES[c]}{d}-{'adam7' if i else 'flat'}-{h}x{w}"
                              f"{'-trns' if t else ''}" for c, d, i, (h, w), t in CASES])
def test_png_variant_equals_cv2(tmp_path, ctype, depth, interlace, hw, trns):
    data = variant(ctype, depth, interlace, hw, trns, seed=depth + 7 * ctype)
    want = _cv2(data)
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == hw + ({3: 3}.get(ctype, CHANNELS[ctype]),)
    np.testing.assert_array_equal(png.to_rgb(got), want)
    (tmp_path / "v.png").write_bytes(data)
    np.testing.assert_array_equal(png.imread_rgb(tmp_path / "v.png"), want)
    gray = _cv2(data, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(png.imread_gray(tmp_path / "v.png"), gray)
    np.testing.assert_array_equal(png.decode_png(data, gray=True), gray)


def test_sixteen_bits_read_by_their_high_byte():
    """16-bit samples become 8 by the high byte, not rounded (what libpng's
    strip_16 gives cv2): 0x12ff reads 0x12."""
    samples = np.array([[[0x12FF, 0x0080, 0xFFFF], [0x0001, 0x7F80, 0x8000]]])
    got = png.decode_png(write_png(samples, 2, 16))
    np.testing.assert_array_equal(got, [[[0x12, 0x00, 0xFF], [0x00, 0x7F, 0x80]]])
    np.testing.assert_array_equal(got, _cv2(write_png(samples, 2, 16)))


@pytest.mark.parametrize("depth", [8, 16])
def test_gray_conversion_is_libpngs_at_cv2s_weights(depth):
    """cv2's gray read of a colour PNG is libpng's ``rgb_to_gray`` at 0.299
    and 0.587: weights 9797, 19234 and 3737 over 2**15, truncated at 8 bits
    (the rounded form and ``cvtColor`` differ on about half of these
    pixels), rounded at 16 bits and then cut to the high byte."""
    rng = np.random.default_rng(depth)
    samples = rng.integers(0, 1 << depth, (256, 256, 3))
    data = write_png(samples, 2, depth)
    want = _cv2(data, cv2.IMREAD_GRAYSCALE)
    r, g, b = (samples[..., k] for k in range(3))
    s = 9797 * r + 19234 * g + 3737 * b
    formula = (s >> 15) if depth == 8 else ((s + 16384) >> 15) >> 8
    np.testing.assert_array_equal(want, formula)
    np.testing.assert_array_equal(png.decode_png(data, gray=True), want)
    other = ((s + 16384) >> 15) if depth == 8 else (s >> 15) >> 8
    assert (other != want).mean() > 0.3 if depth == 8 else (other != want).any()


def _with_chunks(data, extra, after="IHDR"):
    """The PNG with ``extra`` (whole chunks) after its chunk ``after``."""
    chunks = _split(data)
    at = next(i for i, c in enumerate(chunks) if c[4:8] == after.encode()) + 1
    return png.SIGNATURE + b"".join(chunks[:at]) + extra + b"".join(chunks[at:])


def _icc_profile(gamma: float = 2.2) -> bytes:
    """A small ICC v2 RGB display profile (D50 primaries, one gamma curve
    for each channel), which cv2 cannot write into a PNG."""
    def s15(v):
        return struct.pack(">i", round(v * 65536))

    def xyz(x, y, z):
        return b"XYZ \0\0\0\0" + s15(x) + s15(y) + s15(z)

    curve = b"curv\0\0\0\0" + struct.pack(">IH", 1, round(gamma * 256)) + b"\0\0"
    tags = [(b"rXYZ", xyz(0.4361, 0.2225, 0.0139)), (b"gXYZ", xyz(0.3851, 0.7169, 0.0971)),
            (b"bXYZ", xyz(0.1431, 0.0606, 0.7141)), (b"wtpt", xyz(0.9642, 1.0, 0.8249)),
            (b"rTRC", curve), (b"gTRC", curve), (b"bTRC", curve)]
    at, table, body = 128 + 4 + 12 * len(tags), struct.pack(">I", len(tags)), b""
    for sig, data in tags:
        body += b"\0" * (-(at + len(body)) % 4)
        table += sig + struct.pack(">II", at + len(body), len(data))
        body += data
    header = (struct.pack(">I", at + len(body)) + b"none" + bytes([2, 0x10, 0, 0]) + b"mntr"
              + b"RGB XYZ " + b"\0" * 12 + b"acspAPPL" + b"\0" * 24 + s15(0.9642) + s15(1.0)
              + s15(0.8249) + b"none" + b"\0" * 44)
    assert len(header) == 128
    return header + table + body


GAMMA_CHUNKS = {
    # the gamma cv2's libpng weighs a colour pixel's gray value in
    "gAMA-0.45455": _chunk(b"gAMA", struct.pack(">I", 45455)),
    "gAMA-2.2": _chunk(b"gAMA", struct.pack(">I", 220000)),
    "gAMA-0.95-edge": _chunk(b"gAMA", struct.pack(">I", 95000)),  # its reciprocal counts
    "gAMA-1.04": _chunk(b"gAMA", struct.pack(">I", 104000)),  # not significant
    "sRGB": _chunk(b"sRGB", b"\x00"),
    "sRGB-over-gAMA": _chunk(b"gAMA", struct.pack(">I", 30000)) + _chunk(b"sRGB", b"\x01"),
    "first-gAMA": _chunk(b"gAMA", struct.pack(">I", 30000)) + _chunk(b"gAMA",
                                                                    struct.pack(">I", 200000)),
    "sBIT-10-gAMA": _chunk(b"gAMA", struct.pack(">I", 45455)),  # sBIT: the test adds it
    "cHRM-only": _chunk(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000,
                                             15000, 6000)),
    # an ICC profile alone: libpng takes no gamma from it (only a profile it
    # knows for sRGB's would count), so cv2 reads as without it
    "iCCP-only": _chunk(b"iCCP", b"display\0\0" + zlib.compress(_icc_profile())),
    "iCCP-then-gAMA": _chunk(b"iCCP", b"display\0\0" + zlib.compress(_icc_profile()))
    + _chunk(b"gAMA", struct.pack(">I", 45455)),
}
GAMMA_CASES = [(c, d, i, g) for c in (2, 3, 6) for d in DEPTHS[c] if d >= 4 for i in (0, 1)
               for g in GAMMA_CHUNKS]


@pytest.mark.parametrize("ctype,depth,interlace,chunk", GAMMA_CASES,
                         ids=[f"{NAMES[c]}{d}-{'adam7' if i else 'flat'}-{g}"
                              for c, d, i, g in GAMMA_CASES])
def test_gray_read_under_a_file_gamma_equals_cv2(ctype, depth, interlace, chunk):
    """A colour PNG that states its gamma (``gAMA``, or ``sRGB``, which wins
    over it) is read to gray in linear light, as libpng does for cv2: each
    sample through the to-linear table, the weighted sum back through the
    from-linear one (16-bit tables cut to 11 bits, or to ``sBIT``'s), a
    pixel of three equal samples kept.  A gamma libpng finds insignificant,
    a ``cHRM`` alone or an ``iCCP`` alone changes nothing; the colour read
    never changes.
    The chunk is placed before ``PLTE`` as the specification asks, and
    again after it, where libpng ignores it."""
    data = variant(ctype, depth, interlace, (37, 53), False, seed=depth + 7 * ctype)
    extra = GAMMA_CHUNKS[chunk]
    if chunk.startswith("sBIT"):  # 10 significant bits (at most the samples' depth)
        bits = min(10, 8 if ctype == 3 else depth)
        extra = _chunk(b"sBIT", bytes([bits] * (3 if ctype == 3 else CHANNELS[ctype]))) + extra
    for after in (("IHDR", "PLTE") if ctype == 3 else ("IHDR",)):
        tagged = _with_chunks(data, extra, after)
        gray = _cv2(tagged, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(png.decode_png(tagged, gray=True), gray)
        np.testing.assert_array_equal(png.to_rgb(png.decode_png(tagged)), _cv2(tagged))


SERVED = [(2, 16, 0), (0, 16, 1), (3, 4, 1), (3, 8, 0), (4, 8, 1), (0, 1, 0), (6, 16, 1)]


@pytest.mark.parametrize("ctype,depth,interlace", SERVED,
                         ids=[f"{NAMES[c]}{d}-{'adam7' if i else 'flat'}"
                              for c, d, i in SERVED])
def test_png_payloads_equal_the_jax_servers(ctype, depth, interlace):
    """The session server's PNG payloads gain the same cases: the port's
    decode equals the JAX server's (cv2.imdecode)."""
    data = base64.b64encode(variant(ctype, depth, interlace, (37, 53), ctype in (0, 3),
                                    seed=3)).decode()
    got = server.decode_image_payload(data)
    want = jserver.decode_image_payload(data)
    assert got.dtype == np.float32 and got.shape == want.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


def test_forbidden_and_damaged_pngs_raise():
    """A palette image without PLTE, an interlace method past 1, image data
    that inflates short, a cut chunk: ValueError, and cv2 refuses each."""
    ok = variant(3, 4, 1, (9, 17), False)
    ihdr, plte, *_, iend = _split(ok)
    no_plte = png.SIGNATURE + b"".join(c for c in _split(ok) if c[4:8] != b"PLTE")
    bad_interlace = (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 17, 9, 8, 2, 0, 0, 2))
                     + b"".join(_split(ok)[2:]))
    short = png.SIGNATURE + ihdr + plte + _chunk(b"IDAT", zlib.compress(b"\0" * 20)) + iend
    for data, what in ((no_plte, "PLTE"), (bad_interlace, "interlace 2"),
                       (short, "image data holds"), (ok[:len(ok) - 30], "cut short")):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=what):
            png.decode_png(data)


def _split(data):
    """The chunks of a PNG, each with its length and CRC (the first is IHDR)."""
    out, at = [], len(png.SIGNATURE)
    while at < len(data):
        n = struct.unpack(">I", data[at:at + 4])[0]
        out.append(data[at:at + 12 + n])
        at += 12 + n
    return out

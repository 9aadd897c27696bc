"""Test-side Motion-JPEG writers: baseline JPEG pictures written from
quantised coefficients (any DQT, 8- or 16-bit; the standard Huffman
tables, a table holding every symbol, or none; restart intervals;
interleaved or one scan a component; SOF markers and precisions the
decoder refuses), the tools on libjpeg-turbo's pictures (``strip_dht``,
``with_segments``), and the containers: AVI under any fourcc
(``torch_video_files.write_avi``) and ISO BMFF with a ``jpeg`` or an
``mp4v`` (objectTypeIndication 0x6C) sample entry
(``torch_h264_files.write_mp4``).  Imported by ``tests/test_torch_mjpeg.py``
and ``scripts/make_mjpeg_fixtures.py``; not a test file itself.

    picture(coefs, w, h, ...)      -> bytes   one JPEG picture
    random_picture(rng, w, h, ...) -> bytes   random coefficients
    imencode(bgr, sampling, ...)   -> bytes   libjpeg-turbo's picture (cv2)
    write_avi / write_mp4          the containers
    write_cv2(path, bgr, api)      cv2.VideoWriter's MJPG: OpenCV's own
                                   encoder or FFmpeg's
"""

from __future__ import annotations

import pathlib
import re
import struct

import numpy as np

from torch_jpeg_encoders import huffman_codes, segment

MJPEG_OTI = 0x6C  # esds objectTypeIndication of JPEG (ISO/IEC 14496-1, as FFmpeg maps it)
SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
             "444": ((1, 1), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
             "411": ((4, 1), (1, 1), (1, 1)), "gray": ((1, 1),)}

# T.81 Annex K.3 (libavcodec's default tables), read from the decoder's
# source: (counts of 1..16-bit codes, symbols)
_HOST_SRC = pathlib.Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch" / "csrc" \
    / "host" / "mjpeg.cpp"


def _c_array(src: str, name: str) -> list:
    body = re.search(name + r"\[[^=]*= \{(.*?)\};", src, re.S).group(1)
    return [int(v, 0) for v in re.findall(r"0x[0-9a-f]+|\d+", body)]


_SRC = _HOST_SRC.read_text()
STD_DC = [(_c_array(_SRC, "DC_LUM_BITS"), _c_array(_SRC, "DC_VALS")),
          (_c_array(_SRC, "DC_CHROM_BITS"), _c_array(_SRC, "DC_VALS"))]
STD_AC = [(_c_array(_SRC, "AC_LUM_BITS"), _c_array(_SRC, "AC_LUM_VALS")),
          (_c_array(_SRC, "AC_CHROM_BITS"), _c_array(_SRC, "AC_CHROM_VALS"))]
# every DC category (0-16) and every run/size, EOB and ZRL, in 5 and 8 bits
FULL_DC = ([0, 0, 0, 0, 17] + [0] * 11, list(range(17)))
FULL_AC = ([0] * 7 + [242] + [0] * 8, [0, 0xF0] + [r << 4 | s for r in range(16)
                                                   for s in range(1, 16)])


def codes(table) -> dict:
    """symbol -> (code, length) of a table's canonical codes."""
    return {s: (int(c, 2), len(c)) for s, c in huffman_codes(*table).items()}


class _Writer:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int):
    size = abs(int(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def _sizes(w, h, factors):
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mbw, mbh = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    return hmax, vmax, mbw, mbh


def block_grid(w: int, h: int, sampling: str) -> list:
    """(rows, columns) of coefficient blocks each component codes."""
    factors = SAMPLINGS[sampling]
    _, _, mbw, mbh = _sizes(w, h, factors)
    return [(mbh * fv, mbw * fh) for fh, fv in factors]


def picture(coefs, w: int, h: int, sampling: str = "420", quant=None, restart: int = 0,
            tables="std", dht: bool = True, separate: bool = False, sof: int = 0xC0,
            bits: int = 8, ids=None, app=(), com=(), eoi: bool = True) -> bytes:
    """A baseline JPEG picture of ``coefs`` (one int array a component,
    (rows, columns, 64) quantised coefficients in zigzag order, the DC as
    the value, not its difference; ``block_grid`` gives the shapes).
    ``quant``: a table a component (64 values in zigzag order; over 255
    written as a 16-bit table), default all ones.  ``tables``: "std" (the
    Annex K tables, luma for the first component and chroma for the
    others) or "full" (every symbol); ``dht`` False leaves the DHT out (only
    right with "std": the decoder's defaults).  ``separate`` codes one scan
    a component (non-interleaved; a scan's MCU is one block and covers the
    component's own width).  ``app``/``com``: (marker, body) segments and
    comment bodies written after SOI."""
    factors = SAMPLINGS[sampling]
    nc = len(factors)
    ids = ids or list(range(1, nc + 1))
    quant = quant or [[1] * 64] * nc
    hmax, vmax, mbw, mbh = _sizes(w, h, factors)
    out = bytearray(b"\xff\xd8")
    for marker, body in app:
        out += segment(marker, body)
    for text in com:
        out += segment(0xFE, text)
    for c in range(nc):
        q = quant[c]
        wide = max(q) > 255
        out += segment(0xDB, bytes([(int(wide) << 4) | c])
                       + b"".join(struct.pack(">H" if wide else "B", int(v)) for v in q))
    dcs = [FULL_DC] * 2 if tables == "full" else STD_DC
    acs = [FULL_AC] * 2 if tables == "full" else STD_AC
    if dht:
        for cls, tabs in ((0, dcs), (1, acs)):
            for idx, (counts, symbols) in enumerate(tabs):
                out += segment(0xC4, bytes([cls << 4 | idx] + counts + symbols))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(sof, bytes([bits]) + struct.pack(">HH", h, w) + bytes([nc]) + b"".join(
        bytes([ids[c], factors[c][0] << 4 | factors[c][1], c]) for c in range(nc)))
    dc_codes = [codes(t) for t in dcs]
    ac_codes = [codes(t) for t in acs]
    scans = [[c] for c in range(nc)] if separate or nc == 1 else [list(range(nc))]
    for scan in scans:
        out += segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in scan) + b"\x00\x3f\x00")
        wr = _Writer()
        pred = [0] * nc
        if len(scan) == 1:
            c = scan[0]
            rows = -(-h // (8 * (vmax // factors[c][1])))
            cols = -(-w // (8 * (hmax // factors[c][0])))
            units = [[(c, r, x)] for r in range(rows) for x in range(cols)]
        else:
            units = [[(c, my * fv + y, mx * fh + x) for c in scan
                      for fh, fv in [factors[c]] for y in range(fv) for x in range(fh)]
                     for my in range(mbh) for mx in range(mbw)]
        for k, unit in enumerate(units):
            if restart and k and k % restart == 0:
                wr.flush()
                wr.out += bytes([0xFF, 0xD0 + (k // restart - 1) % 8])
                pred = [0] * nc
            for c, r, x in unit:
                blk = coefs[c][r, x]
                t = min(c, 1)
                size, bits_ = _magnitude(int(blk[0]) - pred[c])
                pred[c] = int(blk[0])
                wr.put(*dc_codes[t][size])
                wr.put(bits_, size)
                run = 0
                last = max([i for i in range(1, 64) if blk[i]], default=0)
                for i in range(1, last + 1):
                    if not blk[i]:
                        run += 1
                        continue
                    while run > 15:
                        wr.put(*ac_codes[t][0xF0])
                        run -= 16
                    size, bits_ = _magnitude(int(blk[i]))
                    wr.put(*ac_codes[t][run << 4 | size])
                    wr.put(bits_, size)
                    run = 0
                if last < 63:
                    wr.put(*ac_codes[t][0])
        wr.flush()
        out += wr.out
    if eoi:
        out += b"\xff\xd9"
    return bytes(out)


def random_coefs(rng, w: int, h: int, sampling: str = "420", spread: float = 8.0,
                 dc_range=(-1024, 1016), ac_max: int = 1023) -> list:
    """Random quantised coefficients: a DC in ``dc_range`` and a few AC
    terms a block, fewer at high frequency, each at most ``ac_max``."""
    out = []
    for rows, cols in block_grid(w, h, sampling):
        c = np.zeros((rows, cols, 64), np.int64)
        c[..., 0] = rng.integers(dc_range[0], dc_range[1] + 1, (rows, cols))
        scale = spread / (1 + np.arange(63))
        ac = np.round(rng.laplace(0, 1, (rows, cols, 63)) * scale).astype(np.int64)
        ac[rng.random((rows, cols, 63)) < 0.5] = 0
        c[..., 1:] = np.clip(ac, -ac_max, ac_max)
        out.append(c)
    return out


def random_picture(rng, w: int, h: int, sampling: str = "420", **kw) -> bytes:
    """A picture of random coefficients under a random DQT (8-bit, or
    16-bit with ``wide``) and the ``picture`` options in ``kw``."""
    wide = kw.pop("wide", False)
    spread = kw.pop("spread", 8.0)
    nc = len(SAMPLINGS[sampling])
    top = 4000 if wide else 255
    quant = [list(rng.integers(1, top + 1, 64)) for _ in range(nc)]
    return picture(random_coefs(rng, w, h, sampling, spread), w, h, sampling, quant=quant, **kw)


AVI1 = b"AVI1\0\0" + b"\0" * 8  # the APP0 UVC cameras write: polarity 0 (progressive)


def imencode(bgr: np.ndarray, sampling: str = "420", quality: int = 95, restart: int = 0,
             progressive: bool = False) -> bytes:
    """``cv2.imencode``'s baseline JPEG (libjpeg-turbo; the standard Huffman
    tables) of a (H, W, 3) BGR or (H, W) frame; ``restart`` in MCUs."""
    import cv2

    flags = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
             cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if bgr.ndim == 3:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  {"420": 0x221111, "422": 0x211111, "444": 0x111111, "440": 0x121111,
                   "411": 0x411111}[sampling]]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(bgr), flags)
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


def write_cv2(path, bgr: np.ndarray, fps: float = 30.0, api: str = "opencv",
              quality=None) -> None:
    """(n, H, W, 3) BGR frames through ``cv2.VideoWriter`` as MJPG: "opencv"
    its own encoder (CAP_OPENCV_MJPEG, AVI; ``quality`` its
    VIDEOWRITER_PROP_QUALITY), "ffmpeg" FFmpeg's (the container by the
    suffix: AVI ``MJPG``, MOV ``jpeg``, MP4 ``mp4v``)."""
    import cv2

    n, h, w, _ = bgr.shape
    backend = cv2.CAP_OPENCV_MJPEG if api == "opencv" else cv2.CAP_FFMPEG
    writer = cv2.VideoWriter(str(path), backend, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write MJPG into {path} through {api}")
    if quality is not None:
        writer.set(cv2.VIDEOWRITER_PROP_QUALITY, quality)
    for f in bgr:
        writer.write(np.ascontiguousarray(f))
    writer.release()


def strip_dht(data: bytes) -> bytes:
    """``data`` without its DHT segments (as UVC cameras' frames come: the
    decoder's default tables, which must be the ones it was coded with)."""
    out, at = bytearray(data[:2]), 2
    while at < len(data):
        marker = data[at + 1]
        if marker == 0xDA:
            return bytes(out + data[at:])
        length = struct.unpack(">H", data[at + 2:at + 4])[0]
        if marker != 0xC4:
            out += data[at:at + 2 + length]
        at += 2 + length
    return bytes(out)


def with_segments(data: bytes, segments) -> bytes:
    """``data`` with (marker, body) segments written after its SOI."""
    return data[:2] + b"".join(segment(m, b) for m, b in segments) + data[2:]


def write_avi(path, samples, width: int, height: int, fps: int = 30, fourcc: bytes = b"MJPG",
              keys=None) -> None:
    """An AVI of the pictures (every non-empty one a key frame)."""
    from torch_video_files import write_avi as avi

    avi(path, samples, width, height, fps, fourcc,
        keys=[k for k, s in enumerate(samples) if s] if keys is None else keys)


class _Codec:
    """``torch_h264_files.write_mp4``'s codec hook for Motion-JPEG."""

    def __init__(self, esds: bool):
        self.esds = esds

    @staticmethod
    def is_ps(unit) -> bool:
        return False

    @staticmethod
    def is_sync(units) -> bool:
        return True

    def config(self, ps, length_size) -> bytes:
        if not self.esds:
            return b""
        from torch_h264_files import _full

        dcd = bytes([4, 13, MJPEG_OTI, 0x11]) + b"\0" * 11
        es = bytes([3, 3 + len(dcd) + 3, 0, 1, 0]) + dcd + bytes([6, 1, 2])
        return _full(b"esds", 0, 0, es)


def write_mp4(path, samples, width: int, height: int, fps: int = 30, fourcc: bytes = b"jpeg",
              brand: bytes = b"qt  ", **kw) -> None:
    """An ISO BMFF file of the pictures: sample entry ``jpeg`` (QuickTime),
    or ``mp4v`` whose esds names JPEG (0x6C), as FFmpeg's muxers write
    them."""
    from torch_h264_files import write_mp4 as mp4

    mp4(path, [[s] for s in samples], width, height, fps, fourcc=fourcc, length_size=0,
        brand=brand, codec=_Codec(fourcc == b"mp4v"), **kw)

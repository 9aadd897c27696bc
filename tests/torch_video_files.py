"""Video files for the port's video tests and fixtures, written by cv2
(``cv2.VideoWriter``: libavcodec's MPEG-4 Part 2 encoder) from seeded
numpy frames, edits of them that cv2 cannot write (a VOP marked not
coded, another sample entry's fourcc, a VOL flag set, a sample cut
short), and a stream of flat blocks moved at half-pel vectors without
rounding (``dc_stream``) in an AVI file (``write_avi``).

Imported by ``tests/test_torch_video.py`` and
``scripts/make_video_fixtures.py``; needs cv2 (5.0.0, the decode the port is held to).
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

VOP_START = b"\x00\x00\x01\xb6"
VOL_START = b"\x00\x00\x01\x20"


def frames(kind: str, w: int, h: int, n: int, seed: int, step: int = 2) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR frames panning ``step`` pixels a frame over a
    seeded field: "tex" uniform noise (coarse quantisers), "smooth" a
    random colour field at 1/16 of the size, bilinearly upsampled (what
    ViT-L with random weights tracks), "waves" sums of sines."""
    import cv2

    rng = np.random.default_rng(seed)
    W = w + step * n
    if kind == "tex":
        field = rng.integers(0, 256, (h, W, 3), dtype=np.uint8)
    elif kind == "smooth":
        low = rng.random((max(h // 16, 2), max(W // 16, 2), 3))
        field = np.clip(255 * cv2.resize(low, (W, h), interpolation=cv2.INTER_LINEAR), 0,
                        255).round().astype(np.uint8)
    elif kind == "waves":
        y, x = np.mgrid[0:h, 0:W]
        field = np.stack([128 + 100 * np.sin(x / 17.0 + c + seed) * np.cos(y / 23.0 - c)
                          for c in range(3)], -1).clip(0, 255).astype(np.uint8)
    else:
        raise ValueError(kind)
    return np.stack([field[:, i * step:i * step + w] for i in range(n)])


def write_video(path, fourcc: str, bgr: np.ndarray, fps: float = 30.0) -> None:
    """The frames through ``cv2.VideoWriter`` (the container by the suffix)."""
    import cv2

    n, h, w, _ = bgr.shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} into {path}")
    for f in bgr:
        writer.write(np.ascontiguousarray(f))
    writer.release()


def _samples(data: bytes):
    """(offset, size) of each video sample, through the port's container reader."""
    from mast3r_slam_tpu_torch.data.video import read_avi, read_mp4

    track = read_avi(data) if data[:4] == b"RIFF" else read_mp4(data)
    return list(zip(track.offsets.tolist(), track.sizes.tolist()))


def _bits(data: bytes, at: int, n: int = 256) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data[at:at + n // 8], dtype=np.uint8))


def _clear_bit(data: bytearray, at: int, bit: int) -> None:
    data[at + bit // 8] &= ~(0x80 >> (bit % 8)) & 0xFF


def _set_bit(data: bytearray, at: int, bit: int) -> None:
    data[at + bit // 8] |= 0x80 >> (bit % 8)


def uncode_vop(data: bytes, k: int) -> bytes:
    """``data`` with sample k's VOP marked not coded (``vop_coded`` 0): a
    valid stream whose sample k libavcodec outputs no frame for, the rest
    of the sample left as stuffing."""
    out = bytearray(data)
    off, size = _samples(data)[k]
    at = off + bytes(out[off:off + size]).index(VOP_START) + 4
    bits = _bits(out, at)
    p = 2  # vop_coding_type
    while bits[p]:  # modulo_time_base
        p += 1
    p += 1
    time_bits = _time_increment_bits(data)
    if not bits[p] or not bits[p + 1 + time_bits]:
        raise ValueError("VOP header markers not where expected")
    _clear_bit(out, at, p + 2 + time_bits)
    return bytes(out)


def _vol_fields(data: bytes):
    """The byte of the first VOL's start code's end and the bit offsets of
    its fields (a cv2-written VOL: no aspect or VBV extras)."""
    at = data.index(VOL_START) + 4
    bits = _bits(data, at)
    p = 1 + 8  # random_accessible_vol, video_object_type_indication
    verid = 1
    if bits[p]:
        verid = int("".join(map(str, bits[p + 1:p + 5])), 2)
        p += 7
    p += 1
    if int("".join(map(str, bits[p:p + 4])), 2) == 15:
        p += 16
    p += 4
    fields = {}
    if bits[p]:
        fields["low_delay"] = p + 3
        if bits[p + 4]:
            raise ValueError("a VOL with VBV parameters")
        p += 5
    else:
        p += 1
    p += 2 + 1  # shape, marker
    res = int("".join(map(str, bits[p:p + 16])), 2)
    p += 16 + 1
    tib = max(int(res - 1).bit_length(), 1)
    if bits[p]:
        p += tib
    p += 1
    p += 1 + 13 + 1 + 13 + 1  # marker, width, marker, height, marker
    fields["interlaced"] = p
    p += 2  # interlaced, obmc_disable
    fields["sprite_enable"] = p
    p += 1 if verid == 1 else 2
    fields["not_8_bit"] = p
    fields["quant_type"] = p + 1
    return at, fields, tib


def _time_increment_bits(data: bytes) -> int:
    return _vol_fields(data)[2]


def set_vol_flag(data: bytes, field: str) -> bytes:
    """``data`` with one flag of every VOL copy set (cleared for
    ``low_delay``): ``interlaced``, ``sprite_enable``, ``not_8_bit``,
    ``quant_type`` (MPEG matrices) or ``low_delay`` (B-VOPs allowed)."""
    out = bytearray(data)
    at = 0
    while True:
        i = data.find(VOL_START, at)
        if i < 0:
            return bytes(out)
        start, fields, _ = _vol_fields(data[i:])
        (_clear_bit if field == "low_delay" else _set_bit)(out, i + start, fields[field])
        at = i + 4


def set_stsd_fourcc(data: bytes, fourcc: bytes) -> bytes:
    """An ISO BMFF file with its video sample entry renamed (``mp4v`` to
    ``avc1``, say): the same bytes, another codec."""
    i = data.index(b"stsd")
    j = data.index(b"mp4v", i)
    return data[:j] + fourcc + data[j + 4:]


def cut_sample(data: bytes, k: int, keep: int) -> bytes:
    """An ISO BMFF file whose sample k is listed ``keep`` bytes long in
    ``stsz`` (the rest of its bytes left in ``mdat``, unread)."""
    out = bytearray(data)
    i = data.index(b"stsz") + 4
    fixed, count = struct.unpack(">II", data[i + 4:i + 12])
    if fixed or k >= count:
        raise ValueError("stsz holds no per-sample table")
    struct.pack_into(">I", out, i + 12 + 4 * k, keep)
    return bytes(out)


# --- a test-side MPEG-4 writer for what cv2's encoder does not make --------
#
# cv2's streams hardly ever put a 0 under a half-pel average without
# rounding, where libavcodec's 8-wide averages (unless asked to be bit-exact)
# differ from exact ones.
# ``dc_stream`` writes one: an I-VOP of flat 8x8 blocks at quantised DC
# levels 0 and odd (a block at level L decodes to pixels L at quantiser 2),
# then P-VOPs that move every macroblock by one vector, no residual,
# ``vop_rounding_type`` alternating from 1.

_DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7)]
_DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8)]
_MV = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9)]


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> None:
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def finish(self) -> bytes:
        self.bits.append(0)  # next_start_code's stuffing: 0, then 1s to a byte
        while len(self.bits) % 8:
            self.bits.append(1)
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def _vop_header(bits: _Bits, coding_type: int, time_inc: int, time_bits: int) -> None:
    bits.put(0x1B6, 32)
    bits.put(coding_type, 2)
    bits.put(0, 1)  # modulo_time_base
    bits.put(1, 1)
    bits.put(time_inc, time_bits)
    bits.put(1, 1)
    bits.put(1, 1)  # vop_coded


def _dc_i_vop(luma: np.ndarray, chroma: np.ndarray, time_bits: int) -> bytes:
    """luma (2 mbh, 2 mbw) and chroma (2, mbh, mbw) quantised DC levels."""
    mbh, mbw = chroma.shape[1:]
    bits = _Bits()
    _vop_header(bits, 0, 0, time_bits)
    bits.put(0, 3)  # intra_dc_vlc_thr
    bits.put(2, 5)  # vop_quant: DC scale 8
    stored = [np.full((2 * mbh + 1, 2 * mbw + 2), 1024), np.full((mbh + 1, mbw + 2), 1024),
              np.full((mbh + 1, mbw + 2), 1024)]

    def predict(arr, y, x, n, mx, my):  # libavcodec's ff_mpeg4_pred_dc
        a, b, c = arr[y + 1, x], arr[y, x], arr[y, x + 1]
        if my == 0 and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and mx == 0:
                b = a = 1024
        if mx == 0 and my == 1 and n in (0, 4, 5):
            b = 1024
        return ((c if abs(a - b) < abs(b - c) else a) + 4) // 8

    for my in range(mbh):
        for mx in range(mbw):
            bits.put(1, 1)  # MCBPC: intra, no chroma coefficients
            bits.put(0, 1)  # ac_pred_flag
            bits.put(3, 4)  # CBPY: no luma coefficients
            for n in range(6):
                if n < 4:
                    y, x = 2 * my + (n >> 1), 2 * mx + (n & 1)
                    arr, level, table = stored[0], int(luma[y, x]), _DC_LUM
                else:
                    y, x = my, mx
                    arr, level, table = stored[n - 3], int(chroma[n - 4, my, mx]), _DC_CHROM
                diff = level - int(predict(arr, y, x, n, mx, my))
                arr[y + 1, x + 1] = 8 * level
                size = abs(diff).bit_length()
                bits.put(*table[size])
                if size:
                    bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)
    return bits.finish()


def _moved_p_vop(mv, mbw: int, mbh: int, rounding: int, time_inc: int,
                 time_bits: int, resync_at=None) -> bytes:
    bits = _Bits()
    _vop_header(bits, 1, time_inc, time_bits)
    bits.put(rounding, 1)
    bits.put(0, 3)  # intra_dc_vlc_thr
    bits.put(2, 5)  # vop_quant
    bits.put(1, 3)  # vop_fcode_forward
    for my in range(mbh):
        for mx in range(mbw):
            if my * mbw + mx == resync_at:  # a video packet header, its marker disabled
                bits.put(0, 1)  # stuffing: a 0, then 1s to the byte
                while len(bits.bits) % 8:
                    bits.put(1, 1)
                bits.put(1, 17)  # resync_marker at vop_fcode_forward 1
                bits.put(resync_at, (mbw * mbh - 1).bit_length())
                bits.put(2, 5)  # quant_scale
                bits.put(0, 1)  # header_extension_code
            bits.put(0, 1)  # coded
            bits.put(1, 1)  # MCBPC: inter, no chroma coefficients
            bits.put(3, 2)  # CBPY: no luma coefficients
            pred = (0, 0) if mx == my == 0 else mv  # every other predictor is mv itself
            for d in (mv[0] - pred[0], mv[1] - pred[1]):
                bits.put(*_MV[abs(d)])
                if d:
                    bits.put(int(d < 0), 1)
    return bits.finish()


def dc_stream(headers: bytes, width: int, height: int, mvs, seed: int, resync_at=None) -> list:
    """Samples of an I-VOP (``headers``, a cv2 stream's VOS/VOL/user data
    for ``width`` x ``height``, opening it) then a P-VOP a vector of
    ``mvs`` (half-pel units, each under 9); with ``resync_at``, the first
    P-VOP holds a video packet header before that macroblock, which a VOL
    of ``resync_marker_disable`` 1 does not announce."""
    rng = np.random.default_rng(seed)
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    time_bits = _time_increment_bits(headers)
    luma = rng.choice([0, 1, 3, 5, 7], (2 * mbh, 2 * mbw))
    chroma = rng.choice([0, 1, 3, 7], (2, mbh, mbw))
    out = [headers + _dc_i_vop(luma, chroma, time_bits)]
    for k, mv in enumerate(mvs):
        out.append(_moved_p_vop(mv, mbw, mbh, 1 - k % 2, k + 1, time_bits,
                                resync_at if k == 0 else None))
    return out


def write_avi(path, samples, width: int, height: int, fps: int = 30,
              fourcc: bytes = b"XVID", keys=(0,)) -> None:
    """A RIFF AVI of one video stream (``idx1``, the samples ``keys`` keyframes)."""
    def chunk(tag: bytes, body: bytes) -> bytes:
        return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    def listed(kind: bytes, body: bytes) -> bytes:
        return chunk(b"LIST", kind + body)

    n = len(samples)
    avih = struct.pack("<14I", 1_000_000 // fps, 0, 0, 0x10, n, 0, 1, 0, width, height,
                       0, 0, 0, 0)
    strh = (b"vids" + fourcc + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, fps, 0, n, 0, -1, 0)
            + struct.pack("<4h", 0, 0, width, height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0)
    hdrl = listed(b"hdrl", chunk(b"avih", avih) + listed(b"strl", chunk(b"strh", strh)
                                                          + chunk(b"strf", strf)))
    movi, index, at = b"", b"", 4
    for i, s in enumerate(samples):
        index += b"00dc" + struct.pack("<III", 0x10 if i in keys else 0, at, len(s))
        c = chunk(b"00dc", s)
        movi += c
        at += len(c)
    body = b"AVI " + hdrl + listed(b"movi", movi) + chunk(b"idx1", index)
    pathlib.Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


# --- random valid streams ------------------------------------------------
#
# ``random_stream`` writes I- and P-VOPs whose every syntax element is drawn
# at random from what the decoder takes: intra and inter macroblocks with
# and without DQUANT, MCBPC stuffing, not-coded macroblocks, AC prediction,
# coefficients through the table and its three escapes, motion vectors at
# f_code 1-3 (edge emulation, wrap-around), rounding 0 and 1.  cv2 holds no
# encoder that writes most of this, so cv2's decode of these streams is the
# check.  The VLC tables come from the decoder's source: a wrong entry there
# gives a stream cv2 reads otherwise.

_HOST_SRC = pathlib.Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch" / "csrc" \
    / "host" / "mpeg4.cpp"


def _c_array(src: str, name: str) -> list:
    import re

    body = re.search(name + r"\[[^=]*= \{(.*?)\};", src, re.S).group(1)
    return [int(v, 0) for v in re.findall(r"0x[0-9a-f]+|\d+", body)]


class _Tables:
    def __init__(self):
        src = _HOST_SRC.read_text()
        pairs = lambda name: list(zip(*[iter(_c_array(src, name))] * 2))  # noqa: E731
        self.intra_mcbpc, self.inter_mcbpc = pairs("INTRA_MCBPC"), pairs("INTER_MCBPC")
        self.cbpy, self.mv = pairs("CBPY"), pairs("MV")
        self.y_dc, self.c_dc = _c_array(src, "Y_DC_SCALE"), _c_array(src, "C_DC_SCALE")
        self.dc = [pairs("DC_LUM"), pairs("DC_CHROM")]
        self.tcoef = {}
        for kind in ("INTRA", "INTER"):
            import re

            rows = re.findall(r"\{([^{}]*)\}", re.search(
                kind + r"_LEVELS\[[^=]*= \{(.*?)\}\};", src, re.S).group(1) + "}")
            symbols = []  # (last, run, level), in the table's order
            for last, row in enumerate(rows):
                for run, n in enumerate(int(v) for v in re.findall(r"\d+", row)):
                    symbols += [(last, run, v) for v in range(1, n + 1)]
            assert len(symbols) == 102, len(symbols)
            max_level, max_run = {}, {}
            for last, run, v in symbols:
                max_level[last, run] = max(max_level.get((last, run), 0), v)
                max_run[last, v] = max(max_run.get((last, v), 0), run)
            self.tcoef[kind == "INTRA"] = (pairs(f"{kind}_TCOEF"), symbols, max_level, max_run)


def _coefficients(bits: _Bits, rng, tables: _Tables, intra: bool) -> None:
    """One coded block's AC events, from scan position 0 (intra) or -1."""
    codes, symbols, max_level, max_run = tables.tcoef[intra]
    esc = codes[102]
    i = 0 if intra else -1
    events = int(rng.integers(1, 6))
    for e in range(events):
        last = int(e == events - 1 or i >= 61)
        room = (63 if last else 62) - i  # positions this event may advance
        kind = rng.choice(4, p=[0.7, 0.1, 0.1, 0.1])
        if kind == 3:  # fixed-length escape
            run = int(rng.integers(0, room))
            level = int(rng.integers(1, 200)) * int(rng.choice([-1, 1]))
            bits.put(*esc)
            bits.put(3, 2)
            bits.put(last, 1)
            bits.put(run, 6)
            bits.put(1, 1)
            bits.put(level & 0xFFF, 12)
            bits.put(1, 1)
        else:
            extra = (lambda s: max_run[s[0], s[2]] + 1) if kind == 2 else (lambda s: 0)
            ok = [k for k, s in enumerate(symbols)
                  if s[0] == last and s[1] + extra(s) + 1 <= room]
            if not ok:  # nothing of this kind fits: end the block on a plain code
                last, room, kind, extra = 1, 63 - i, 0, (lambda s: 0)
                ok = [k for k, s in enumerate(symbols) if s[0] == 1 and s[1] + 1 <= room]
            k = int(rng.choice(ok))
            run = symbols[k][1] + extra(symbols[k])
            if kind:
                bits.put(*esc)
                bits.put(2 if kind == 2 else 0, 2 if kind == 2 else 1)
            bits.put(*codes[k])
            bits.put(int(rng.integers(2)), 1)
        i += run + 1
        if last:
            return


class _RandomVop:
    """One VOP's macroblocks of random syntax; the intra DC predictions
    (``dc``: libavcodec's stored values, 1024 outside and where the last
    macroblock was not intra) are tracked so that no DC level goes
    negative, which libavcodec takes for an error."""

    def __init__(self, tables: _Tables, rng, mbw: int, mbh: int, dc):
        self.t, self.rng, self.mbw, self.mbh, self.dc = tables, rng, mbw, mbh, dc

    def dc_level(self, bits: _Bits, n: int, mx: int, my: int, q: int) -> None:
        if n < 4:
            arr, y, x, scale = self.dc[0], 2 * my + (n >> 1), 2 * mx + (n & 1), self.t.y_dc[q]
        else:
            arr, y, x, scale = self.dc[n - 3], my, mx, self.t.c_dc[q]
        a, b, c = int(arr[y + 1, x]), int(arr[y, x]), int(arr[y, x + 1])
        if my == 0 and n != 3:  # ff_mpeg4_pred_dc's first slice line
            if n != 2:
                b = c = 1024
            if n != 1 and mx == 0:
                b = a = 1024
        if mx == 0 and my == 1 and n in (0, 4, 5):
            b = 1024
        pred = ((c if abs(a - b) < abs(b - c) else a) + (scale >> 1)) // scale
        size = int(self.rng.choice(10, p=[0.2, 0.2, 0.15, 0.15, 0.1, 0.08, 0.05, 0.04, 0.02,
                                           0.01]))
        diff = 0 if size == 0 else int(self.rng.integers(1 << (size - 1), 1 << size))
        diff = -diff if self.rng.random() < 0.5 and pred >= diff else diff
        arr[y + 1, x + 1] = min(max((pred + diff) * scale, 0), 2047)
        bits.put(*self.t.dc[n >= 4][size])
        if size:
            bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)
            if size > 8:
                bits.put(1, 1)

    def clean(self, mx: int, my: int) -> None:
        self.dc[0][2 * my + 1:2 * my + 3, 2 * mx + 1:2 * mx + 3] = 1024
        self.dc[1][my + 1, mx + 1] = self.dc[2][my + 1, mx + 1] = 1024

    def macroblock(self, bits: _Bits, p_vop: bool, f_code: int, mx: int, my: int,
                   q: int) -> int:
        """Writes one macroblock; returns the quantiser after it."""
        rng, t = self.rng, self.t
        if rng.random() < 0.03:  # MCBPC stuffing
            if p_vop:
                bits.put(0, 1)
                bits.put(*t.inter_mcbpc[20])
            else:
                bits.put(*t.intra_mcbpc[8])
        if p_vop and rng.random() < 0.15:
            bits.put(1, 1)  # not coded
            self.clean(mx, my)
            return q
        if p_vop:
            bits.put(0, 1)
        intra = not p_vop or rng.random() < 0.15
        dquant = rng.random() < 0.3
        cbpc, cbpy = int(rng.integers(4)), int(rng.integers(16))
        if p_vop:
            bits.put(*t.inter_mcbpc[((1 if intra else 0) + (2 if dquant else 0)) * 4 + cbpc])
        else:
            bits.put(*t.intra_mcbpc[(4 if dquant else 0) + cbpc])
        if intra:
            bits.put(int(rng.integers(2)), 1)  # ac_pred_flag
        bits.put(*t.cbpy[cbpy if intra else cbpy ^ 15])
        if dquant:
            d = int(rng.integers(4))
            bits.put(d, 2)
            q = min(max(q + (-1, -2, 1, 2)[d], 1), 31)
        if not intra:
            self.clean(mx, my)
            for _ in range(2):
                code = int(rng.choice(33, p=np.r_[[0.3, 0.25, 0.15, 0.1], np.full(29, 0.2 / 29)]))
                bits.put(*t.mv[code])
                if code:
                    bits.put(int(rng.integers(2)), 1)
                    if f_code > 1:
                        bits.put(int(rng.integers(1 << (f_code - 1))), f_code - 1)
        cbp = cbpc | (cbpy << 2)
        for n in range(6):
            if intra:
                self.dc_level(bits, n, mx, my, q)
            if (cbp >> (5 - n)) & 1:
                _coefficients(bits, rng, t, intra)
        return q


def random_stream(headers: bytes, width: int, height: int, n_p: int, seed: int) -> list:
    """An I-VOP (``headers`` opening it, as ``dc_stream``) and ``n_p``
    P-VOPs of random valid syntax.  No VOP holds 14 zero bits in a row:
    libavcodec looks for a resync marker after each macroblock."""
    tables = _Tables()
    rng = np.random.default_rng(seed)
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    time_bits = _time_increment_bits(headers)
    dc = [np.full((2 * mbh + 1, 2 * mbw + 2), 1024), np.full((mbh + 1, mbw + 2), 1024),
          np.full((mbh + 1, mbw + 2), 1024)]
    out = []
    for k in range(n_p + 1):
        while True:
            vop_dc = [a.copy() for a in dc]
            writer = _RandomVop(tables, rng, mbw, mbh, vop_dc)
            bits = _Bits()
            _vop_header(bits, int(k > 0), k, time_bits)
            f_code = int(rng.integers(1, 4))
            if k:
                bits.put(int(rng.integers(2)), 1)  # vop_rounding_type
            bits.put(0, 3)  # intra_dc_vlc_thr
            q = int(rng.integers(1, 32))
            bits.put(q, 5)
            if k:
                bits.put(f_code, 3)
            for my in range(mbh):
                for mx in range(mbw):
                    q = writer.macroblock(bits, k > 0, f_code, mx, my, q)
            vop = bits.finish()
            if "0" * 14 not in "".join(map(str, bits.bits[32:])):
                dc = vop_dc
                break
        out.append(headers + vop if k == 0 else vop)
    return out

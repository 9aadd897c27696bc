"""Test-side JPEG encoders for the codings that neither cv2 nor PIL writes:
arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive, with DAC
conditioning and restarts) and lossless JPEG (SOF3).  Imported by
``tests/test_torch_jpeg.py``, the other JPEG tests,
``scripts/make_image_fixtures.py`` and ``scripts/make_resync_fixtures.py``;
not a test file itself.  ``break_restart`` puts a restart marker out of
place in any stream.

The arithmetic coder is the QM coder of ITU T.81 Annex D with the
statistics of F.1.4 (sequential DC and AC) and G.1.3 (progressive DC and
AC, first and refinement scans), written after the decisions libjpeg's
``jcarith.c`` takes, so that libjpeg-turbo (``cv2.imdecode``) reads the
streams.  Its coefficients come from a plain forward DCT of the image
(``Frame``); any coefficients serve, since the tests compare two decoders
of the same stream.

    arithmetic_jpeg(img, ...)  -> bytes   (H, W) gray, (H, W, 3) or (H, W, 4)
    lossless_jpeg(planes, ...) -> bytes   one or more (H, W) sample planes
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position -> natural (row-major) position
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), and
# entry 113, the fixed estimate of 0.5 (T.851 Table 5) for sign and
# refinement bits
ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]
FIXED = 113  # the state of the fixed bin

# (Qe, Next_Index_LPS with Switch_MPS in bit 7, Next_Index_MPS) by state
_QE = [(q, (s << 7) | nl, nm) for q, nl, nm, s in ARITAB]


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class QMEncoder:
    """The QM encoder of T.81 D.1 as ``jcarith.c`` writes it: C register
    with three spacer bits, a stack of 0xFF bytes that a carry may turn to
    0x00, stuffing after each 0xFF, and no trailing zero bytes."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _pending_zeros(self):
        self.out.extend(b"\x00" * self.zc)
        self.zc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._pending_zeros()
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def _no_carry(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._pending_zeros()
            self._emit(self.buffer)
        if self.sc:
            self._pending_zeros()
            self.out.extend(b"\xff\x00" * self.sc)
            self.sc = 0

    def encode(self, st: bytearray, i: int, val: int):
        """One binary decision ``val`` in the statistics bin ``st[i]``."""
        sv = st[i]
        qe, nl, nm = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalisation and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._no_carry()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def flush(self) -> bytes:
        """Terminate the code (D.1.8) and return the segment's bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._no_carry()
        if self.c & 0x7FFF800:
            self._pending_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        out = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return out


# ---------------------------------------------------------------------------
# coefficients
# ---------------------------------------------------------------------------

# the T.81 K.1 example tables, scaled by libjpeg's quality formula
_LUMA_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
_CHROMA_Q = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32


def quant_table(quality: int, chroma: bool = False) -> np.ndarray:
    """(64,) natural order, 8-bit entries."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = np.array(_CHROMA_Q if chroma else _LUMA_Q, np.int64)
    return np.clip((base * scale + 50) // 100, 1, 255)


_C = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                for x in range(8)] for u in range(8)])


def _blocks(plane: np.ndarray, bh: int, bw: int, q: np.ndarray) -> np.ndarray:
    """(bh, bw, 64) quantised DCT coefficients, natural order, of ``plane``
    padded by edge replication to bh x bw blocks."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64), ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    b = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
    f = np.einsum("ux,abxy,vy->abuv", _C, b, _C).reshape(bh, bw, 64)
    return np.round(f / q).astype(np.int64)


def _downsample(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64), ((0, -h % fy), (0, -w % fx)), mode="edge")
    return p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3))


SAMPLING = {"444": (1, 1), "422": (2, 1), "440": (1, 2), "420": (2, 2)}  # luma (h, v)


class Frame:
    """The components of an image to code: ids, sampling factors, the
    quantisation table each uses, and their coefficient blocks over the
    MCU-padded grid."""

    def __init__(self, img: np.ndarray, quality: int = 75, sampling: str = "420"):
        img = np.asarray(img)
        self.height, self.width = img.shape[:2]
        if img.ndim == 2:
            planes, factors = [img], [(1, 1)]
        elif img.shape[2] == 3:
            f = img.astype(np.float64)
            r, g, b = f[..., 0], f[..., 1], f[..., 2]
            y = 0.299 * r + 0.587 * g + 0.114 * b
            planes = [y, 128 + (b - y) / 1.772, 128 + (r - y) / 1.402]
            factors = [SAMPLING[sampling], (1, 1), (1, 1)]
        else:
            planes = [img[..., k] for k in range(img.shape[2])]
            factors = [SAMPLING[sampling], (1, 1), (1, 1), SAMPLING[sampling]][:img.shape[2]]
        self.ncomp = len(planes)
        self.h = [f[0] for f in factors]
        self.v = [f[1] for f in factors]
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        self.tq = [0 if k in (0, 3) else 1 for k in range(self.ncomp)]
        self.qt = [quant_table(quality), quant_table(quality, chroma=True)]
        self.coef = []
        self.dims = []  # (downsampled height, width) of each component
        for k, plane in enumerate(planes):
            sub = _downsample(plane, self.vmax // self.v[k], self.hmax // self.h[k])
            self.dims.append((-(-self.height * self.v[k] // self.vmax),
                              -(-self.width * self.h[k] // self.hmax)))
            self.coef.append(_blocks(sub, self.mcuy * self.v[k], self.mcux * self.h[k],
                                     self.qt[self.tq[k]]))

    def header(self, marker: int) -> bytes:
        """DQT and the frame header, component k with id k + 1."""
        body = struct.pack(">BHHB", 8, self.height, self.width, self.ncomp)
        for k in range(self.ncomp):
            body += bytes([k + 1, (self.h[k] << 4) | self.v[k], self.tq[k]])
        dqt = b"".join(bytes([t]) + bytes(int(x) for x in np.array(q)[NATURAL])
                       for t, q in enumerate(self.qt[:1 + (self.ncomp > 1)]))
        return segment(0xDB, dqt) + segment(marker, body)

    def units(self, comps):
        """The blocks of a scan in coding order: (component, block row,
        block column) of each block of each MCU."""
        if len(comps) == 1:
            k = comps[0]
            h, w = self.dims[k]
            return [[(k, by, bx)] for by in range(-(-h // 8)) for bx in range(-(-w // 8))]
        return [[(k, my * self.v[k] + yy, mx * self.h[k] + xx)
                 for k in comps for yy in range(self.v[k]) for xx in range(self.h[k])]
                for my in range(self.mcuy) for mx in range(self.mcux)]


# ---------------------------------------------------------------------------
# arithmetic coding (jcarith.c's decisions)
# ---------------------------------------------------------------------------

class _Stats:
    def __init__(self, dac_dc, dac_ac):
        self.dc = {}
        self.ac = {}
        self.L = {t: lu[0] for t, lu in dac_dc.items()}
        self.U = {t: lu[1] for t, lu in dac_dc.items()}
        self.K = dict(dac_ac)
        self.fixed = bytearray([FIXED])

    def bins(self, table, kind):
        store = self.dc if kind == "dc" else self.ac
        if table not in store:
            store[table] = bytearray(64 if kind == "dc" else 256)
        return store[table]


def _encode_magnitude(enc, st, i, v, k_ctx):
    """F.1.4.4 (F.8, F.9): the category and the low bits of v >= 1 - 1,
    starting at bin i; ``k_ctx`` = (stats, X1 of the second bin) for AC,
    None for DC (whose X1 is 20)."""
    v -= 1
    m = 0
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if k_ctx is None:
            i = 20
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        elif v2:
            enc.encode(st, i, 1)
            m <<= 1
            i = k_ctx
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1
    return m


def _encode_dc(enc, stats, st, state, ci, value, tbl):
    """F.1.4.1: the difference of ``value`` from the prediction."""
    diff = value - state["last"][ci]
    s0 = state["ctx"][ci]
    if diff == 0:
        enc.encode(st, s0, 0)
        state["ctx"][ci] = 0
        return
    state["last"][ci] = value
    enc.encode(st, s0, 1)
    if diff > 0:
        enc.encode(st, s0 + 1, 0)
        i, ctx, v = s0 + 2, 4, diff
    else:
        enc.encode(st, s0 + 1, 1)
        i, ctx, v = s0 + 3, 8, -diff
    # the category m, computed as the encoder's loop computes it
    m = 0 if v == 1 else 1 << ((v - 1).bit_length() - 1)
    if m < (1 << stats.L.get(tbl, 0)) >> 1:
        ctx = 0
    elif m > (1 << stats.U.get(tbl, 1)) >> 1:
        ctx += 8
    state["ctx"][ci] = ctx
    _encode_magnitude(enc, st, i, v, None)


def _encode_ac_value(enc, stats, st, i, k, v, tbl):
    """A nonzero AC value at position k (its sign, then F.8 and F.9),
    ``i`` the bin of its zero decision minus 1 (3 (k - 1))."""
    enc.encode(stats.fixed, 0, 1 if v < 0 else 0)
    x1 = 189 if k <= stats.K.get(tbl, 5) else 217
    _encode_magnitude(enc, st, i + 2, abs(v), x1)


def _ac_sequential(enc, stats, st, block, tbl, lo=1, hi=63, al=0):
    """F.1.4.2 / G.1.3.2: the band lo..hi of a block, point-transformed by al."""
    def pt(x):
        return x >> al if x >= 0 else -((-x) >> al)

    ke = hi
    while ke >= lo and pt(block[NATURAL[ke]]) == 0:
        ke -= 1
    k = lo
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)  # not the end of the block
        while pt(block[NATURAL[k]]) == 0:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        enc.encode(st, i + 1, 1)
        _encode_ac_value(enc, stats, st, i, k, pt(block[NATURAL[k]]), tbl)
        k += 1
    if k <= hi:
        enc.encode(st, 3 * (k - 1), 1)


def _ac_refine(enc, stats, st, block, lo, hi, ah, al):
    """G.1.3.3 (Figure G.10) as jcarith.c's encode_mcu_AC_refine codes it."""
    def mag(x, s):
        return (x if x >= 0 else -x) >> s

    ke = hi
    while ke > 0 and mag(block[NATURAL[ke]], al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and mag(block[NATURAL[kex]], ah) == 0:
        kex -= 1
    k = lo
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            x = block[NATURAL[k]]
            v = mag(x, al)
            if v:
                if v >> 1:
                    enc.encode(st, i + 2, v & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(stats.fixed, 0, 1 if x < 0 else 0)
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= hi:
        enc.encode(st, 3 * (k - 1), 1)


# libjpeg's jpeg_simple_progression: (components or None for all, Ss, Se, Ah, Al)
YCC_SCRIPT = [(None, 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
              ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), (None, 0, 0, 1, 0), ([2], 1, 63, 1, 0),
              ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]


def other_script(ncomp):
    """The script for gray and four components: each AC scan per component."""
    each = list(range(ncomp))
    return ([(None, 0, 0, 0, 1)] + [([k], 1, 5, 0, 2) for k in each]
            + [([k], 6, 63, 0, 2) for k in each] + [([k], 1, 63, 2, 1) for k in each]
            + [(None, 0, 0, 1, 0)] + [([k], 1, 63, 1, 0) for k in each])


def _encode_scan(frame, stats, comps, ss, se, ah, al, progressive, restart, tables):
    """One scan's entropy-coded segment, restart markers included."""
    enc = QMEncoder()
    out = bytearray()
    units = frame.units(comps)
    state = {"last": [0] * len(comps), "ctx": [0] * len(comps)}

    def reset_stats():
        for ci, k in enumerate(comps):
            td, ta = tables[k]
            if not progressive or (ss == 0 and ah == 0):
                stats.bins(td, "dc")[:] = bytes(64)
                state["last"][ci] = state["ctx"][ci] = 0
            if not progressive or se:
                stats.bins(ta, "ac")[:] = bytes(256)

    reset_stats()
    for u, blocks in enumerate(units):
        if restart and u and u % restart == 0:
            out += enc.flush() + bytes([0xFF, 0xD0 + (u // restart - 1) % 8])
            reset_stats()
        for k, by, bx in blocks:
            ci = comps.index(k)
            td, ta = tables[k]
            block = frame.coef[k][by, bx]
            if not progressive:
                _encode_dc(enc, stats, stats.bins(td, "dc"), state, ci, int(block[0]), td)
                _ac_sequential(enc, stats, stats.bins(ta, "ac"), [int(x) for x in block], ta)
            elif ss == 0 and ah == 0:
                _encode_dc(enc, stats, stats.bins(td, "dc"), state, ci, int(block[0]) >> al, td)
            elif ss == 0:
                enc.encode(stats.fixed, 0, (int(block[0]) >> al) & 1)
            elif ah == 0:
                _ac_sequential(enc, stats, stats.bins(ta, "ac"), [int(x) for x in block], ta,
                               ss, se, al)
            else:
                _ac_refine(enc, stats, stats.bins(ta, "ac"), [int(x) for x in block], ss, se,
                           ah, al)
    return bytes(out + enc.flush())


def arithmetic_jpeg(img, quality=75, sampling="420", progressive=False, restart=0,
                    dac_dc=None, dac_ac=None, interleaved=True, adobe=None,
                    tables=None, scans=None) -> bytes:
    """An arithmetic-coded JPEG of ``img`` ((H, W) gray, (H, W, 3) RGB coded
    as YCbCr under a JFIF marker, (H, W, 4) with an Adobe marker whose
    transform is ``adobe``): SOF9, or SOF10 with ``progressive`` (libjpeg's
    simple progression).  ``restart`` is the
    DRI interval in MCUs, ``dac_dc`` maps a DC conditioning table to its
    (L, U), ``dac_ac`` an AC table to its Kx (both sent in a DAC segment),
    ``tables`` gives each component its (DC, AC) table, ``interleaved``
    False codes a sequential stream one component a scan, and ``scans``
    keeps only the first that many scans (a client's partial frame)."""
    frame = Frame(img, quality, sampling)
    n = frame.ncomp
    tables = tables or [(min(k, 1), min(k, 1)) for k in range(n)]
    stats = _Stats(dac_dc or {}, dac_ac or {})
    out = b"\xff\xd8"
    if n == 3:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if n == 4:
        out += segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe or 0]))
    out += frame.header(0xCA if progressive else 0xC9)
    if dac_dc or dac_ac:
        body = b"".join(bytes([t, (u << 4) | lo]) for t, (lo, u) in sorted((dac_dc or {}).items()))
        body += b"".join(bytes([16 + t, kx]) for t, kx in sorted((dac_ac or {}).items()))
        out += segment(0xCC, body)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    if progressive:
        steps = YCC_SCRIPT if n == 3 else other_script(n)
    elif interleaved:
        steps = [(None, 0, 63, 0, 0)]
    else:
        steps = [([k], 0, 63, 0, 0) for k in range(n)]
    for i, (comps, ss, se, ah, al) in enumerate(steps[:scans]):
        comps = list(range(n)) if comps is None else comps
        sos = bytes([len(comps)]) + b"".join(bytes([k + 1, (tables[k][0] << 4) | tables[k][1]])
                                             for k in comps) + bytes([ss, se, (ah << 4) | al])
        out += segment(0xDA, sos) + _encode_scan(frame, stats, comps, ss, se, ah, al,
                                                 progressive, restart, tables)
    return out + b"\xff\xd9"


def with_entropy(data: bytes, payload, scan: int = 0) -> bytes:
    """The stream with the entropy-coded data of its ``scan``-th scan
    replaced: each restart interval's by ``payload(i)`` (or the bytes
    ``payload``), its 0xFF bytes stuffed here, the restart markers kept."""
    make = payload if callable(payload) else (lambda i: payload)
    at = -1
    for _ in range(scan + 1):
        at = data.index(b"\xff\xda", at + 1)
    start = at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
    out, i, p = bytearray(data[:start]), 0, start
    while True:
        if data[p] == 0xFF and data[p + 1] != 0:  # a marker: restart or the scan's end
            out += make(i).replace(b"\xff", b"\xff\x00")
            i += 1
            if not 0xD0 <= data[p + 1] <= 0xD7:
                return bytes(out + data[p:])
            out += data[p:p + 2]
            p += 2
        else:
            p += 1


def scan_spans(data: bytes) -> list:
    """(start, end) of each scan's entropy-coded data, restart markers in it."""
    out, p = [], 2
    while p + 4 <= len(data) and data[p + 1] != 0xD9:
        length = struct.unpack(">H", data[p + 2:p + 4])[0]
        if data[p + 1] != 0xDA:
            p += 2 + length
            continue
        start = end = p + 2 + length
        while not (data[end] == 0xFF and data[end + 1] != 0 and not 0xD0 <= data[end + 1] <= 0xD7):
            end += 1
        out.append((start, end))
        p = end
    return out


def restart_positions(data: bytes, scan: int) -> dict:
    """Where each RSTn of a scan's data begins, by n (the first of each)."""
    start, end = scan_spans(data)[scan]
    out = {}
    for i in range(start, end - 1):
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            out.setdefault(data[i + 1] - 0xD0, i)
    return out


def break_restart(data: bytes, scan: int, how: str, n: int = 3) -> bytes:
    """The stream with RSTn of its ``scan``-th scan made wrong: replaced by
    the next marker ("next") or the previous one ("previous"), removed, or
    swapped with RSTn+1 ("swapped")."""
    at = restart_positions(data, scan)
    out = bytearray(data)
    if how == "next":
        out[at[n] + 1] = 0xD0 + (n + 1) % 8
    elif how == "previous":
        out[at[n] + 1] = 0xD0 + (n - 1) % 8
    elif how == "removed":
        del out[at[n]:at[n] + 2]
    elif how == "swapped":
        out[at[n] + 1], out[at[(n + 1) % 8] + 1] = 0xD0 + (n + 1) % 8, 0xD0 + n
    else:
        raise ValueError(how)
    return bytes(out)


# ---------------------------------------------------------------------------
# lossless coding (SOF3)
# ---------------------------------------------------------------------------

# the standard luminance DC table (ITU T.81 K.3): categories 0-11
STANDARD_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
# a table of all 17 lossless categories (H.1.2.2: 16 means 32768)
ALL_CATEGORIES = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0], list(range(17)))


def huffman_codes(counts, symbols):
    codes, code, k = {}, 0, 0
    for n, count in enumerate(counts, 1):
        for _ in range(count):
            codes[symbols[k]] = format(code, f"0{n}b")
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def predict(x: np.ndarray, predictor: int, first: bool, initial: int) -> np.ndarray:
    """H.1.1's prediction of each sample of the rows ``x`` (R, W), the
    first of them a restart interval's first row when ``first``."""
    x = x.astype(np.int64)
    p = np.empty_like(x)
    for r in range(x.shape[0]):
        if r == 0 and first:
            p[r, 0] = initial
            p[r, 1:] = x[r, :-1]
            continue
        up = x[r - 1] if r else None
        ra, rb = x[r, :-1], up[1:]
        rc = up[:-1]
        p[r, 0] = up[0]
        p[r, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                    6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
    return p


def lossless_jpeg(planes, precision=8, predictor=1, pt=0, restart_rows=0, interleaved=True,
                  table=STANDARD_DC, extra_diffs=None) -> bytes:
    """A lossless JPEG (SOF3) of one (H, W) sample plane or several of one
    size (each sampled 1x1), samples below 1 << ``precision``: predictor
    1-7 (``Ss``), point transform ``pt`` (the samples' low bits dropped),
    a restart every ``restart_rows`` rows, several components in one
    interleaved scan or a scan each.  ``extra_diffs`` maps (component,
    row, column) to a difference sent in place of the coded one (in
    -32767..32768, 32768 being category 16), for a table such as
    ``ALL_CATEGORIES``."""
    planes = [planes] if np.ndim(planes) == 2 else list(planes)
    H, W = planes[0].shape
    n = len(planes)
    codes = huffman_codes(*table)
    initial = 1 << (precision - pt - 1)
    diffs = []
    for k, plane in enumerate(planes):
        x = np.asarray(plane, np.int64) >> pt
        rows = restart_rows or H
        pred = np.concatenate([predict(x[r:r + rows], predictor, True, initial)
                               for r in range(0, H, rows)])
        d = (x - pred) & 0xFFFF
        d = np.where(d > 32768, d - 65536, d)
        for (kk, r, c), v in (extra_diffs or {}).items():
            if kk == k:
                d[r, c] = v
        diffs.append(d)

    def code(v):
        v = int(v)
        if v == 32768:
            return codes[16]
        s = abs(v).bit_length()
        return codes[s] + (format(v if v > 0 else v + (1 << s) - 1, f"0{s}b") if s else "")

    def entropy(bits):
        b = "".join(bits)
        b += "1" * (-len(b) % 8)
        ent = bytearray()
        for i in range(0, len(b), 8):
            ent.append(int(b[i:i + 8], 2))
            if ent[-1] == 0xFF:
                ent.append(0)
        return bytes(ent)

    def scan(comps):
        sos = bytes([len(comps)]) + b"".join(bytes([k + 1, 0]) for k in comps)
        sos += bytes([predictor, 0, pt])
        out = segment(0xDA, sos)
        rows = restart_rows or H
        for r0 in range(0, H, rows):
            if r0:
                out += bytes([0xFF, 0xD0 + (r0 // rows - 1) % 8])
            bits = [code(diffs[k][r, c]) for r in range(r0, min(r0 + rows, H))
                    for c in range(W) for k in comps]
            out += entropy(bits)
        return out

    counts, symbols = table
    sof = struct.pack(">BHHB", precision, H, W, n) + b"".join(bytes([k + 1, 0x11, 0])
                                                               for k in range(n))
    out = (b"\xff\xd8" + segment(0xC3, sof) + segment(0xC4, bytes([0x00] + counts + symbols)))
    if restart_rows:
        out += segment(0xDD, struct.pack(">H", restart_rows * W))
    for comps in ([list(range(n))] if interleaved else [[k] for k in range(n)]):
        out += scan(comps)
    return out + b"\xff\xd9"

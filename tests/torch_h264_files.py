"""H.264 video files for the port's video tests and fixtures, written here
(cv2 decodes H.264 but holds no encoder for it): CAVLC or CABAC streams
of I and P pictures whose syntax is drawn at random from what the port's
decoder takes (``random_stream``), or coded from a smooth picture that
pans (``smooth_stream``), in Annex B or behind NAL unit lengths, muxed
into ``.mp4``/``.mov`` (``write_mp4``, with a settable ``tkhd`` matrix)
or ``.avi`` (``write_avi`` of ``torch_video_files``).  Needs no cv2.

``random_stream`` draws every I and P ``mb_type`` and ``sub_mb_type``,
I_PCM, intra 4x4/8x8/16x16 and chroma modes (only those whose samples are
available, as the standard requires), skip runs, ``ref_idx`` over up to 4
references, ``mvd`` (vectors far outside the picture too), the mapped
``coded_block_pattern``, ``mb_qp_delta``, both transform sizes and CAVLC
levels of every escape; per picture and slice the deblocking controls,
slice splits, ``num_ref_idx_active_override``, ``ref_pic_list_modification``,
MMCO 1 and non-reference pictures; per stream the picture order count
type, parameter sets in band (repeated, several ids), ``constrained_intra_
pred_flag``, both chroma QP offsets, the VUI and frame cropping.  Levels
are bounded so that no dequantised coefficient or transform sum leaves
16 bits, which the standard forbids and libavcodec does not model.
Under CABAC (``cabac=True``: ``CabacEncoder``, the arithmetic coder of
clause 9.3.4, and ``CabacSlice``, each syntax element's binarisation and
context selection) it also draws cabac_init_idc, slice QPs over 0-51,
``mvd`` past UEG3's prefix and slices that end on a skipped macroblock.
The CAVLC and CABAC tables come from the decoder's source: a wrong entry
there gives a stream cv2 reads otherwise, so cv2's decode is the check.

With ``bframes`` (``schedule``) the pictures are written in decoding
order, B pictures after the anchor that follows them (``pyramid``: the
middle one a reference; ``b_ref``, ``b_anchor`` more references and B
anchors), ``options["display"]`` each one's display index: every B
``mb_type`` and ``sub_mb_type`` (``b_types``, ``b_sub``), B_Skip, both
direct modes (``direct``; temporal only where every reference of the
co-located picture is still held, so that list 0 holds it) under both
``direct8x8`` values, lists by POC with list-1 modification, random
explicit weights (``weighted``, ``bipred_idc`` 1; negative ones too) and
implicit ones (``bipred_idc`` 2), one list length a picture.
``write_mp4(..., display=)`` writes the ``ctts`` and edit FFmpeg's muxer
writes (or another edit list, ``edits``).

Imported by ``tests/test_torch_h264.py``, ``tests/test_torch_h264_b.py``,
``tests/test_torch_video.py``, ``scripts/make_h264_fixtures.py`` and
``chip_smoke.py`` (phases 20-22).
"""

from __future__ import annotations

import pathlib
import re
import struct

import numpy as np

_HOST_DIR = pathlib.Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch" / "csrc" / "host"
_HOST_SRC = _HOST_DIR / "h264.cpp"


def _c_array(src: str, name: str) -> list:
    body = re.search(name + r"\[[^=]*= \{(.*?)\};", src, re.S).group(1)
    return [int(v, 0) for v in re.findall(r"-?0x[0-9a-f]+|-?\d+", body)]


class _Tables:
    def __init__(self):
        src = _HOST_SRC.read_text() + (_HOST_DIR / "cabac.h").read_text()
        a = lambda name: _c_array(src, name)  # noqa: E731
        ln, bt = a("COEFF_TOKEN_LEN"), a("COEFF_TOKEN_BITS")
        self.coeff = [list(zip(ln[68 * c:68 * c + 68], bt[68 * c:68 * c + 68])) for c in range(4)]
        self.chroma_dc = list(zip(a("CHROMADC_TOKEN_LEN"), a("CHROMADC_TOKEN_BITS")))
        ln, bt = a("TOTAL_ZEROS_LEN"), a("TOTAL_ZEROS_BITS")
        self.zeros = [list(zip(ln[16 * t:16 * t + 16], bt[16 * t:16 * t + 16])) for t in range(15)]
        ln, bt = a("CHROMADC_ZEROS_LEN"), a("CHROMADC_ZEROS_BITS")
        self.chroma_zeros = [list(zip(ln[4 * t:4 * t + 4], bt[4 * t:4 * t + 4])) for t in range(3)]
        ln, bt = a("RUN_BEFORE_LEN"), a("RUN_BEFORE_BITS")
        self.run = [list(zip(ln[16 * t:16 * t + 16], bt[16 * t:16 * t + 16])) for t in range(7)]
        self.intra_cbp = {v: k for k, v in enumerate(a("INTRA_CBP"))}
        self.inter_cbp = {v: k for k, v in enumerate(a("INTER_CBP"))}
        self.zigzag4, self.zigzag8 = a("ZIGZAG4"), a("ZIGZAG8")
        self.deq4 = np.array(a("DEQ4")).reshape(6, 3)
        self.deq8 = np.array(a("DEQ8")).reshape(6, 6)
        self.qpc = a("QPC")
        pairs = lambda v: list(zip(v[0::2], v[1::2]))  # noqa: E731
        self.cabac_i = pairs(a("CABAC_INIT_I"))
        p = pairs(a("CABAC_INIT_P"))
        self.cabac_p = [p[460 * k:460 * k + 460] for k in range(3)]
        lps = a("RANGE_LPS")
        self.range_lps = [lps[4 * k:4 * k + 4] for k in range(64)]
        self.trans_lps = a("TRANS_LPS")
        self.sig8, self.last8 = a("SIG8_FRAME"), a("LAST8_FRAME")


_TABLES = None


def tables() -> _Tables:
    global _TABLES
    if _TABLES is None:
        _TABLES = _Tables()
    return _TABLES


# --- bits and NAL units ----------------------------------------------------


class Bits:
    def __init__(self):
        self.parts = []
        self.n = 0

    def u(self, v: int, n: int) -> None:
        if n:
            assert 0 <= v < (1 << n), (v, n)
            self.parts.append(format(v, f"0{n}b"))
            self.n += n

    def flag(self, v) -> None:
        self.u(int(bool(v)), 1)

    def ue(self, v: int) -> None:
        assert v >= 0
        s = format(v + 1, "b")
        self.parts.append("0" * (len(s) - 1) + s)
        self.n += 2 * len(s) - 1

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align_zero(self) -> None:
        self.u(0, (8 - self.n % 8) % 8)

    def rbsp(self, stop: bool = True) -> bytes:
        """The bits with rbsp_trailing_bits (CABAC's flush wrote the stop
        bit: ``stop`` False)."""
        if stop:
            self.u(1, 1)
        self.align_zero()
        s = "".join(self.parts)
        return int(s, 2).to_bytes(len(s) // 8, "big")


def nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    """A NAL unit: its header and the RBSP with emulation prevention."""
    out = bytearray([(ref_idc << 5) | kind])
    zeros = 0
    for c in rbsp:
        if zeros >= 2 and c <= 3:
            out.append(3)
            zeros = 0
        out.append(c)
        zeros = zeros + 1 if c == 0 else 0
    return bytes(out)


def annexb(units) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)


def length_prefixed(units, size: int = 4) -> bytes:
    return b"".join(len(u).to_bytes(size, "big") + u for u in units)


# --- parameter sets ----------------------------------------------------------

HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


def sps(o: dict, sps_id: int = 0) -> bytes:
    """seq_parameter_set_rbsp from the stream options ``o``."""
    b = Bits()
    b.u(o["profile"], 8)
    b.u(o.get("constraints", 0), 8)
    b.u(o.get("level", 40), 8)
    b.ue(sps_id)
    if o["profile"] in HIGH_PROFILES:
        b.ue(o.get("chroma_format", 1))
        b.ue(o.get("bit_depth", 8) - 8)
        b.ue(o.get("bit_depth", 8) - 8)
        b.flag(o.get("bypass", False))
        b.flag(o.get("scaling", False))
    b.ue(o["log2_max_frame_num"] - 4)
    b.ue(o["poc_type"])
    if o["poc_type"] == 0:
        b.ue(o["log2_max_poc_lsb"] - 4)
    elif o["poc_type"] == 1:
        b.flag(o["delta_always_zero"])
        b.se(o["offset_non_ref"])
        b.se(o["offset_t2b"])
        b.ue(len(o["poc_cycle"]))
        for v in o["poc_cycle"]:
            b.se(v)
    b.ue(o["max_ref"])
    b.flag(o.get("gaps_allowed", False))
    b.ue(o["mbw"] - 1)
    b.ue(o["mbh"] - 1)
    b.flag(o.get("frame_mbs_only", True))
    if not o.get("frame_mbs_only", True):
        b.flag(False)
    b.flag(o.get("direct8x8", True))  # direct_8x8_inference_flag
    crop = o["crop"]  # left, right, top, bottom in luma samples
    b.flag(any(crop))
    if any(crop):
        for v in crop:
            b.ue(v // 2)
    vui = o.get("vui")
    b.flag(vui is not None)
    if vui is not None:
        b.flag(True)  # aspect_ratio_info
        b.u(1, 8)
        b.flag(False)  # overscan
        colour = [vui.get(k) for k in ("prim", "trc", "matrix")]
        signal = vui.get("full_range") is not None or colour != [None] * 3
        b.flag(signal)
        if signal:
            b.u(5, 3)
            b.flag(vui.get("full_range", False))
            b.flag(colour != [None] * 3)
            if colour != [None] * 3:
                for v in colour:
                    b.u(2 if v is None else v, 8)
        b.flag(False)  # chroma_loc_info
        b.flag(vui.get("timing", False))
        if vui.get("timing", False):
            b.u(1, 32)
            b.u(60, 32)
            b.flag(True)
        hrd = vui.get("hrd", False)
        for _ in range(2):  # NAL and VCL hrd_parameters
            b.flag(hrd)
            if hrd:
                b.ue(0)
                b.u(4, 4)
                b.u(6, 4)
                b.ue(3999)
                b.ue(9999)
                b.flag(False)
                b.u(23, 5)
                b.u(23, 5)
                b.u(23, 5)
                b.u(24, 5)
        if hrd:
            b.flag(False)  # low_delay_hrd_flag
        b.flag(False)  # pic_struct_present_flag
        reorder = vui.get("reorder")
        b.flag(reorder is not None)
        if reorder is not None:
            b.flag(True)
            b.ue(0)
            b.ue(0)
            b.ue(16)
            b.ue(16)
            b.ue(reorder)
            b.ue(max(reorder, o["max_ref"]))
    return b.rbsp()


def pps(o: dict, pps_id: int = 0, sps_id: int = 0) -> bytes:
    b = Bits()
    b.ue(pps_id)
    b.ue(sps_id)
    b.flag(o.get("cabac", False))
    b.flag(o.get("bottom_poc", False))
    b.ue(o.get("slice_groups", 1) - 1)
    b.ue(o["num_ref_default"] - 1)
    b.ue(o.get("num_ref_l1_default", 1) - 1)
    b.flag(o.get("weighted", False))
    b.u(o.get("bipred_idc", 0), 2)
    b.se(o["init_qp"] - 26)
    b.se(0)
    b.se(o["cqp"][0])
    b.flag(o["deblock_ctrl"])
    b.flag(o["constrained_intra"])
    b.flag(o.get("redundant", False))
    if o["t8"] or o["cqp"][1] != o["cqp"][0]:
        b.flag(o["t8"])
        b.flag(False)
        b.se(o["cqp"][1])
    return b.rbsp()


# --- CAVLC residual blocks -------------------------------------------------------


def write_block(b: Bits, coef, nc: int) -> int:
    """residual_block_cavlc of ``coef`` (levels in scan order) at nC ``nc``
    (-1: chroma DC); returns TotalCoeff."""
    t = tables()
    max_coeff = len(coef)
    nzpos = [i for i, v in enumerate(coef) if v]
    total = len(nzpos)
    levels = [coef[i] for i in reversed(nzpos)]  # highest frequency first
    ones = 0
    for v in levels:
        if abs(v) != 1 or ones == 3:
            break
        ones += 1
    if nc < 0:
        code = t.chroma_dc[total * 4 + ones]
    else:
        code = t.coeff[0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3][total * 4 + ones]
    b.u(code[1], code[0])
    if not total:
        return 0
    for v in levels[:ones]:
        b.flag(v < 0)
    suffix = 1 if total > 10 and ones < 3 else 0
    for i, v in enumerate(levels[ones:], start=ones):
        code = 2 * v - 2 if v > 0 else -2 * v - 1
        if i == ones and ones < 3:
            code -= 2
        if suffix == 0:
            if code < 14:
                b.u(1, code + 1)
            elif code < 30:
                b.u(1, 15)
                b.u(code - 14, 4)
            else:
                b.u(1, 16)
                b.u(code - 30, 12)
        elif code < (15 << suffix):
            b.u(1, (code >> suffix) + 1)
            b.u(code & ((1 << suffix) - 1), suffix)
        else:
            b.u(1, 16)
            b.u(code - (15 << suffix), 12)
        if suffix == 0:
            suffix = 1
        if abs(v) > (3 << (suffix - 1)) and suffix < 6:
            suffix += 1
    if total < max_coeff:
        zeros = nzpos[-1] + 1 - total
        code = (t.chroma_zeros if max_coeff == 4 else t.zeros)[total - 1][zeros]
        b.u(code[1], code[0])
        left = zeros
        desc = list(reversed(nzpos))
        for k in range(total - 1):
            if left <= 0:
                break
            run = desc[k] - desc[k + 1] - 1
            code = t.run[min(left, 7) - 1][run]
            b.u(code[1], code[0])
            left -= run
    return total


# --- the decoder's arithmetic, for bounds and for the encoder's reconstruction ----


def _class4(pos):
    i, j = pos >> 2, pos & 3
    return 0 if not (i & 1 or j & 1) else 1 if (i & 1 and j & 1) else 2


def _class8(pos):
    i, j = pos >> 3, pos & 7
    if not (i & 3) and not (j & 3):
        return 0
    if i & 1 and j & 1:
        return 1
    if (i & 3) == 2 and (j & 3) == 2:
        return 2
    if (not (i & 3) and j & 1) or (i & 1 and not (j & 3)):
        return 3
    if (not (i & 3) and (j & 3) == 2) or ((i & 3) == 2 and not (j & 3)):
        return 4
    return 5


_CLASS4 = np.array([_class4(p) for p in range(16)])
_CLASS8 = np.array([_class8(p) for p in range(64)])
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])


def deq4(levels_raster: np.ndarray, qp: int) -> np.ndarray:
    return levels_raster * (tables().deq4[qp % 6][_CLASS4] << (qp // 6))


def deq8(levels_raster: np.ndarray, qp: int) -> np.ndarray:
    ls = 16 * tables().deq8[qp % 6][_CLASS8]
    if qp >= 36:
        return levels_raster * (ls << (qp // 6 - 6))
    return (levels_raster * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def luma_dc(dc_raster: np.ndarray, qp: int) -> np.ndarray:
    f = _H4 @ dc_raster.reshape(4, 4) @ _H4
    ls = 16 * int(tables().deq4[qp % 6][0])
    if qp >= 36:
        return (f * (ls << (qp // 6 - 6))).reshape(16)
    return ((f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)).reshape(16)


def chroma_dc(c4, qpc: int) -> np.ndarray:
    c = np.asarray(c4).reshape(2, 2)
    f = np.array([[1, 1], [1, -1]]) @ c @ np.array([[1, 1], [1, -1]])
    return (f.reshape(4) * (16 * int(tables().deq4[qpc % 6][0]) << (qpc // 6))) >> 5


def idct4(d: np.ndarray) -> np.ndarray:
    """The 4x4 inverse transform of a (4, 4) array: residuals."""
    def one(x):  # along the last axis
        e0, e1 = x[..., 0] + x[..., 2], x[..., 0] - x[..., 2]
        e2, e3 = (x[..., 1] >> 1) - x[..., 3], x[..., 1] + (x[..., 3] >> 1)
        return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)
    f = one(d)
    g = one(f.swapaxes(-1, -2)).swapaxes(-1, -2)
    return (g + 32) >> 6


def _idct8_1d(d: np.ndarray) -> np.ndarray:
    """The decoder's 8-point inverse transform along the last axis."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., k] for k in range(8))
    a0, a4, a2, a6 = d0 + d4, d0 - d4, (d2 >> 1) - d6, d2 + (d6 >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -d3 + d5 - d7 - (d7 >> 1)
    a3 = d1 + d7 - d3 - (d3 >> 1)
    a5 = -d1 + d7 + d5 + (d5 >> 1)
    a7 = d3 + d5 + d1 + (d1 >> 1)
    b1, b7, b3, b5 = a1 + (a7 >> 2), a7 - (a1 >> 2), a3 + (a5 >> 2), (a3 >> 2) - a5
    return np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7], -1)


def idct8(d: np.ndarray) -> np.ndarray:
    """The 8x8 inverse transform of an (8, 8) array: residuals."""
    return (_idct8_1d(_idct8_1d(d).swapaxes(-1, -2)).swapaxes(-1, -2) + 32) >> 6


def chroma_qp(qp: int, offset: int) -> int:
    return tables().qpc[min(max(qp + offset, 0), 51)]


# --- stream options ----------------------------------------------------------------


def options(width: int, height: int, **kw) -> dict:
    """A stream's options: the frame size, then what ``kw`` sets over the
    defaults (High profile, CAVLC unless ``cabac``, POC type 0, 2
    references)."""
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    o = dict(profile=100, log2_max_frame_num=4, poc_type=0, log2_max_poc_lsb=5, poc_step=2,
             delta_always_zero=False, offset_non_ref=1, offset_t2b=0, poc_cycle=[2],
             max_ref=2, num_ref_default=1, init_qp=28, cqp=[0, 0], deblock_ctrl=True,
             constrained_intra=False, t8=True, vui=None, mbw=mbw, mbh=mbh,
             crop=[0, 16 * mbw - width, 0, 16 * mbh - height], gop=8, nonref=0.0,
             mmco=False, modify=False, override=True, slices=1, extra_nals=False,
             inband=False, pps_ids=(0,), qp_range=(12, 44), intra_in_p=True, mvd=8,
             far_mv=False, p_types=None, i_types=None, pcm=True, slice_i_in_p=False,
             dbk_idc=(0, 1, 2), force_slice_type=None, long_term_idr=False, mmco_op=None,
             gap_at=None, poc_drop_at=None, bframes=0, pyramid=False, b_ref=0.0, b_anchor=0.0,
             bipred_idc=0, weighted=False, direct=None, direct8x8=True, b_types=None,
             b_sub=None, num_ref_l1_default=1, temporal_l0=None)
    if kw.get("cabac"):  # CABAC: slice QPs over the whole range, mvds past UEG3's prefix
        o.update(qp_range=(0, 51), mvd=40)
    o.update(kw)
    return o


# --- a picture's macroblocks -------------------------------------------------------


def _zx(blk):
    return ((blk >> 2) & 1) * 2 + (blk & 1)


def _zy(blk):
    return ((blk >> 3) & 1) * 2 + ((blk >> 1) & 1)


def _zidx(bx, by):
    return ((by >> 1) << 3) | ((bx >> 1) << 2) | ((by & 1) << 1) | (bx & 1)


class Picture:
    """What the syntax of the next macroblocks depends on: the slices so far,
    each macroblock's kind, total_coeff by 4x4 block and intra modes."""

    def __init__(self, mbw: int, mbh: int, constrained: bool):
        self.mbw, self.mbh, self.constrained = mbw, mbh, constrained
        n = mbw * mbh
        self.slice = [-1] * n
        self.kind = [None] * n
        self.nz = np.zeros((n, 24), int)
        self.ipred = np.full((n, 16), -1)
        self.cur_slice = 0
        # what CABAC's contexts read of a neighbour (see h264.cpp's Mb)
        self.cbp = [0] * n
        self.t8 = [False] * n
        self.cmode = [0] * n
        self.dcf = [0] * n  # coded_block_flag of the DC blocks: 1 luma, 2 Cb, 4 Cr
        self.mvd = np.zeros((n, 2, 16, 2), int)  # |mvd| by list and raster 4x4
        self.ref = np.zeros((n, 2, 16), int)  # ref_idx by list (-1: the list not used)
        self.direct = np.zeros((n, 16), bool)  # B_Skip, B_Direct_16x16, B_Direct_8x8 blocks
        self.btype = [-1] * n  # a B macroblock's mb_type

    def avail(self, mx, my) -> bool:
        return (0 <= mx < self.mbw and 0 <= my < self.mbh
                and self.slice[my * self.mbw + mx] == self.cur_slice)

    def intra(self, addr) -> bool:
        return self.kind[addr] not in ("P", "B", "skip")

    def avail_intra(self, mx, my) -> bool:
        return self.avail(mx, my) and (not self.constrained
                                       or self.intra(my * self.mbw + mx))

    def nz_at(self, mx, my, bx, by, plane):
        n = 2 if plane else 4
        if bx < 0:
            mx, bx = mx - 1, bx + n
        if by < 0:
            my, by = my - 1, by + n
        if not self.avail(mx, my):
            return -1
        row = self.nz[my * self.mbw + mx]
        return row[16 + 4 * (plane - 1) + by * 2 + bx] if plane else row[by * 4 + bx]

    def nc(self, mx, my, bx, by, plane=0) -> int:
        a, b = self.nz_at(mx, my, bx - 1, by, plane), self.nz_at(mx, my, bx, by - 1, plane)
        if a >= 0 and b >= 0:
            return (a + b + 1) >> 1
        return a if a >= 0 else b if b >= 0 else 0

    def predicted_mode(self, mx, my, bx, by, cur_modes) -> int:
        dc = False
        got = []
        for nx, ny in ((bx - 1, by), (bx, by - 1)):
            amx, amy = mx, my
            if nx < 0:
                amx, nx = amx - 1, nx + 4
            if ny < 0:
                amy, ny = amy - 1, ny + 4
            if (amx, amy) == (mx, my):
                got.append(cur_modes[ny * 4 + nx])
                continue
            if not self.avail(amx, amy):
                dc = True
                got.append(2)
                continue
            a = amy * self.mbw + amx
            if not self.intra(a) and self.constrained:
                dc = True
                got.append(2)
            elif self.kind[a] not in ("I4", "I8"):
                got.append(2)
            else:
                got.append(int(self.ipred[a][ny * 4 + nx]))
        return 2 if dc else min(got)

    def block_avail(self, mx, my, bx, by, n):
        """(top, left, top-left, top-right) sample availability of the n x n
        intra block at 4x4 position (bx, by)."""
        s = n // 4

        def done(nx, ny):
            if n == 4:
                return _zidx(nx, ny) < _zidx(bx, by)
            return (ny // 2) * 2 + nx // 2 < (by // 2) * 2 + bx // 2

        def nb(nx, ny):
            if ny < 0:
                return self.avail_intra(mx - 1 if nx < 0 else mx + 1 if nx >= 4 else mx, my - 1)
            if nx < 0:
                return self.avail_intra(mx - 1, my)
            if nx >= 4:
                return False
            return done(nx, ny)
        return nb(bx, by - 1), nb(bx - 1, by), nb(bx - 1, by - 1), nb(bx + s, by - 1)


# B mb_types 1-21: (width, height) of each partition and what each predicts
# from (1: list 0, 2: list 1, 3: both), Table 7-14
_B_PAIRS = [(1, 1), (2, 2), (1, 2), (2, 1), (1, 3), (2, 3), (3, 1), (3, 2), (3, 3)]


def b_parts(mb_type: int) -> list:
    """(x, y, w, h, lists) of each partition of B mb_type 1-21."""
    if mb_type <= 3:
        return [(0, 0, 16, 16, mb_type)]
    k = mb_type - 4
    pair = _B_PAIRS[k // 2]
    if k % 2 == 0:  # 16x8
        return [(0, 0, 16, 8, pair[0]), (0, 8, 16, 8, pair[1])]
    return [(0, 0, 8, 16, pair[0]), (8, 0, 8, 16, pair[1])]


# B sub_mb_types 1-12: (lists, width, height) of each sub-partition (0: direct)
B_SUB = {1: (1, 8, 8), 2: (2, 8, 8), 3: (3, 8, 8), 4: (1, 8, 4), 5: (1, 4, 8), 6: (2, 8, 4),
         7: (2, 4, 8), 8: (3, 8, 4), 9: (3, 4, 8), 10: (1, 4, 4), 11: (2, 4, 4), 12: (3, 4, 4)}


def b_small(subs, direct8x8: bool) -> bool:
    """Whether a B_8x8 macroblock holds a partition under 8x8 (no 8x8 transform)."""
    return any((s == 0 and not direct8x8) or (s and B_SUB[s][1:] != (8, 8)) for s in subs)


def valid_nxn_modes(top, left, tl) -> list:
    need_top, need_left, need_tl = {0, 3, 4, 5, 6, 7}, {1, 4, 5, 6, 8}, {4, 5, 6}
    return [m for m in range(9) if (top or m not in need_top) and (left or m not in need_left)
            and (tl or m not in need_tl)]


def valid_16_modes(top, left, tl) -> list:  # 0 V, 1 H, 2 DC, 3 plane
    return [m for m in range(4) if (m != 0 or top) and (m != 1 or left)
            and (m != 3 or (top and left and tl))]


def valid_chroma_modes(top, left, tl) -> list:  # 0 DC, 1 H, 2 V, 3 plane
    return [m for m in range(4) if (m != 1 or left) and (m != 2 or top)
            and (m != 3 or (top and left and tl))]


def write_mb(b: Bits, pic: Picture, mx: int, my: int, d: dict, slice_type: str, o: dict,
             num_ref: int) -> None:
    """One non-skipped macroblock of description ``d`` (see ``RandomPicture.
    describe``) into ``b``; ``pic`` learns its total_coeff and modes."""
    t = tables()
    addr = my * pic.mbw + mx
    kind = d["kind"]
    pic.slice[addr] = pic.cur_slice
    pic.kind[addr] = kind
    base = 5 if slice_type == "P" else 23 if slice_type == "B" else 0
    if kind == "PCM":
        b.ue(base + 25)
        b.align_zero()
        for v in d["pcm"]:
            b.u(int(v), 8)
        pic.nz[addr] = 16
        return
    if kind == "B":
        _write_b(b, pic, mx, my, d, o, num_ref)
        return
    if kind == "P":
        b.ue(d["mb_type"])
        refs = d["refs"]
        if d["mb_type"] < 3:
            if num_ref > 1:
                for r in refs:
                    _te(b, r, num_ref - 1)
        else:
            for s in d["sub"]:
                b.ue(s)
            if num_ref > 1 and d["mb_type"] == 3:
                for r in refs:
                    _te(b, r, num_ref - 1)
        for mv in d["mvd"]:
            b.se(mv[0])
            b.se(mv[1])
        cbp = d["cbp"]
        b.ue(t.inter_cbp[cbp])
        small = d["mb_type"] >= 3 and any(d["sub"])
        if (cbp & 15) and o["t8"] and not small:
            b.flag(d["t8"])
        if cbp:
            b.se(d["dqp"])
        _residual(b, pic, mx, my, d, cbp, False)
        return
    if kind in ("I4", "I8"):
        b.ue(base)
        if o["t8"]:
            b.flag(kind == "I8")
        cur = [-1] * 16
        n = 4 if kind == "I8" else 16
        for k in range(n):
            blk = 4 * k if kind == "I8" else k
            bx, by = _zx(blk), _zy(blk)
            pred = pic.predicted_mode(mx, my, bx, by, cur)
            mode = d["modes"][k]
            if mode == pred:
                b.flag(True)
            else:
                b.flag(False)
                b.u(mode if mode < pred else mode - 1, 3)
            s = 2 if kind == "I8" else 1
            for y in range(by, by + s):
                for x in range(bx, bx + s):
                    cur[y * 4 + x] = mode
        pic.ipred[addr] = cur
        b.ue(d["cmode"])
        cbp = d["cbp"]
        b.ue(t.intra_cbp[cbp])
        if cbp:
            b.se(d["dqp"])
        _residual(b, pic, mx, my, d, cbp, False)
        return
    # I16
    cbp = d["cbp"]
    b.ue(base + 1 + d["mode"] + 4 * (cbp >> 4) + (12 if cbp & 15 else 0))
    b.ue(d["cmode"])
    b.se(d["dqp"])
    _residual(b, pic, mx, my, d, cbp, True)


def _write_b(b: Bits, pic: Picture, mx, my, d: dict, o: dict, num_ref) -> None:
    """A B macroblock (not skipped) under CAVLC: mb_pred or sub_mb_pred, then
    the residual."""
    mt = d["mb_type"]
    b.ue(mt)
    if mt == 22:
        for sub in d["sub"]:
            b.ue(sub)
    for lst in range(2):
        for r in d["refs"][lst]:
            if r >= 0 and num_ref[lst] > 1:
                _te(b, r, num_ref[lst] - 1)
    for lst in range(2):
        for mv in d["mvd"][lst]:
            b.se(mv[0])
            b.se(mv[1])
    cbp = d["cbp"]
    b.ue(tables().inter_cbp[cbp])
    if (cbp & 15) and o["t8"] and _b_t8_allowed(d, o):
        b.flag(d["t8"])
    if cbp:
        b.se(d["dqp"])
    _residual(b, pic, mx, my, d, cbp, False)


def _b_t8_allowed(d: dict, o: dict) -> bool:
    """transform_size_8x8_flag's condition beyond the coded luma and the PPS."""
    if d["mb_type"] == 0:
        return bool(o.get("direct8x8", True))
    if d["mb_type"] == 22:
        return not b_small(d["sub"], o.get("direct8x8", True))
    return True


def _te(b: Bits, v: int, rng: int) -> None:
    if rng == 1:
        b.flag(not v)
    else:
        b.ue(v)


def _residual(b: Bits, pic: Picture, mx, my, d, cbp, i16) -> None:
    addr = my * pic.mbw + mx
    nz = pic.nz[addr]
    nz[:] = 0
    if i16:
        write_block(b, d["dc"], pic.nc(mx, my, 0, 0))
    for b8 in range(4):
        for i4 in range(4):
            blk = 4 * b8 + i4
            bx, by = _zx(blk), _zy(blk)
            if not cbp & (1 << b8):
                continue
            if i16:
                n = write_block(b, d["ac"][blk], pic.nc(mx, my, bx, by))
            elif d.get("t8"):
                n = write_block(b, d["luma8"][b8][i4::4], pic.nc(mx, my, bx, by))
            else:
                n = write_block(b, d["luma"][blk], pic.nc(mx, my, bx, by))
            nz[by * 4 + bx] = n
    if cbp & 0x30:
        for c in range(2):
            write_block(b, d["cdc"][c], -1)
    if cbp >> 4 == 2:
        for c in range(2):
            for k in range(4):
                nz[16 + 4 * c + k] = write_block(b, d["cac"][c][k], pic.nc(mx, my, k & 1, k >> 1,
                                                                             c + 1))


# --- CABAC (clause 9.3) ------------------------------------------------------------


class CabacEncoder:
    """The arithmetic encoder of 9.3.4 (EncodeDecision, EncodeBypass,
    EncodeTerminate, EncodeFlush) over the contexts 9.3.1.1 initialises;
    bits collect in ``out`` until ``drain`` moves them into a ``Bits``."""

    def __init__(self, intra_slice: bool, idc: int, qp: int):
        t = tables()
        q = min(max(qp, 0), 51)
        self.p, self.mps = [], []
        for m, n in (t.cabac_i if intra_slice else t.cabac_p[idc]):
            pre = min(max(((m * q) >> 4) + n, 1), 126)
            self.p.append(63 - pre if pre <= 63 else pre - 64)
            self.mps.append(int(pre > 63))
        self.lps, self.trans = t.range_lps, t.trans_lps
        self.out = []
        self.start()

    def start(self) -> None:  # InitEncoder: at a slice's start and after I_PCM samples
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def _put(self, bit: int) -> None:
        if self.first:
            self.first = False
        else:
            self.out.append(bit)
        if self.outstanding:
            self.out.extend([1 - bit] * self.outstanding)
            self.outstanding = 0

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, bin_: int) -> None:
        p, mps = self.p[ctx], self.mps[ctx]
        lps = self.lps[p][(self.range >> 6) & 3]
        self.range -= lps
        if bin_ != mps:
            self.low += self.range
            self.range = lps
            if p == 0:
                self.mps[ctx] = 1 - mps
            self.p[ctx] = self.trans[p]
        else:
            self.p[ctx] = min(p + 1, 62)
        self._renorm()

    def bypass(self, bin_: int) -> None:
        self.low <<= 1
        if bin_:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, bin_: int) -> None:
        self.range -= 2
        if bin_:
            self.low += self.range
            self.range = 2  # EncodeFlush; its last bit, 1, ends a slice as rbsp_stop_one_bit
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.out += [(self.low >> 8) & 1, 1]
        else:
            self._renorm()

    def exp_golomb(self, v: int, k: int) -> None:  # UEGk's bypass suffix
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)

    def drain(self, b: Bits) -> None:
        if self.out:
            b.parts.append("".join(map(str, self.out)))
            b.n += len(self.out)
            self.out = []


_SIG, _LAST, _ABS = (105, 120, 134, 149, 152, 402), (166, 181, 195, 210, 213, 417), \
    (227, 237, 247, 257, 266, 426)


class CabacSlice:
    """One slice's macroblocks under CABAC: each syntax element binarised
    and its contexts chosen from the neighbours as 9.3.2-9.3.3 (and the
    decoder, ``h264.cpp``) choose them."""

    def __init__(self, b: Bits, pic: Picture, intra_slice: bool, idc: int, qp: int,
                 transform_8x8: bool, direct8x8: bool = True):
        while b.n % 8:  # cabac_alignment_one_bit
            b.u(1, 1)
        self.b, self.pic, self.t8_mode, self.direct8x8 = b, pic, transform_8x8, direct8x8
        self.e = CabacEncoder(intra_slice, idc, qp)
        self.last_dqp = 0

    # -- neighbours -------------------------------------------------------------

    def _addr(self, mx, my):
        return my * self.pic.mbw + mx if self.pic.avail(mx, my) else None

    def _cover(self, mx, my, x, y):
        """(address, raster 4x4) of luma sample (x, y) relative to the
        macroblock, None where not available."""
        nmx, nmy = (mx - 1 if x < 0 else mx), (my - 1 if y < 0 else my)
        k = (((y + 16) & 15) >> 2) * 4 + (((x + 16) & 15) >> 2)
        if (nmx, nmy) == (mx, my):
            return my * self.pic.mbw + mx, k
        a = self._addr(nmx, nmy)
        return (a, k) if a is not None else (None, k)

    # -- the macroblock layer ------------------------------------------------------

    def skip(self, mx, my, skipped: bool, b_slice: bool = False) -> None:
        pic = self.pic
        inc = sum(1 for a in (self._addr(mx - 1, my), self._addr(mx, my - 1))
                  if a is not None and pic.kind[a] != "skip")
        self.e.decision((24 if b_slice else 11) + inc, int(skipped))
        if skipped:
            addr = my * pic.mbw + mx
            pic.slice[addr], pic.kind[addr] = pic.cur_slice, "skip"
            pic.nz[addr] = 0
            pic.cbp[addr], pic.t8[addr], pic.dcf[addr] = 0, False, 0
            pic.mvd[addr], pic.ref[addr], pic.direct[addr] = 0, 0, True
            self.last_dqp = 0

    def end(self, last: bool) -> None:
        self.e.terminate(int(last))
        if last:
            self.e.drain(self.b)

    def _mb_type_i(self, off: int, inc: int, kind: str, t: int) -> None:
        e, in_i = self.e, off == 3
        e.decision(off + inc, int(kind != "I4" and kind != "I8"))
        if kind in ("I4", "I8"):
            return
        e.terminate(int(kind == "PCM"))
        if kind == "PCM":
            return
        pred, chroma, luma = (t - 1) % 4, ((t - 1) // 4) % 3, int(t >= 13)
        e.decision(off + (3 if in_i else 1), luma)
        e.decision(off + (4 if in_i else 2), int(chroma != 0))
        if chroma:
            e.decision(off + (5 if in_i else 2), int(chroma == 2))
        e.decision(off + (6 if in_i else 3), pred >> 1)
        e.decision(off + (7 if in_i else 3), pred & 1)

    def mb_type(self, mx, my, d: dict, slice_type: str) -> None:
        kind, e, pic = d["kind"], self.e, self.pic
        t = 0
        if kind == "I16":
            cbp = d["cbp"]
            t = 1 + d["mode"] + 4 * (cbp >> 4) + (12 if cbp & 15 else 0)
        if slice_type == "B":
            self._mb_type_b(mx, my, d, t)
            return
        if slice_type == "P":
            if kind == "P":
                mt = d["mb_type"]
                e.decision(14, 0)
                e.decision(15, int(mt in (1, 2)))
                e.decision(17 if mt in (1, 2) else 16, int(mt in (1, 3)))
                return
            e.decision(14, 1)
            self._mb_type_i(17, 0, kind, t)
            return
        inc = sum(1 for a in (self._addr(mx - 1, my), self._addr(mx, my - 1))
                  if a is not None and pic.kind[a] not in ("I4", "I8"))
        self._mb_type_i(3, inc, kind, t)

    def _mb_type_b(self, mx, my, d: dict, t: int) -> None:
        """mb_type in a B slice (ctxIdx 27-35): its first bin's context from
        the neighbours that are neither B_Skip nor B_Direct_16x16."""
        e, pic, kind = self.e, self.pic, d["kind"]
        inc = sum(1 for a in (self._addr(mx - 1, my), self._addr(mx, my - 1))
                  if a is not None and pic.kind[a] != "skip"
                  and not (pic.kind[a] == "B" and pic.btype[a] == 0))
        mt = d["mb_type"] if kind == "B" else None
        e.decision(27 + inc, int(mt != 0))
        if mt == 0:
            return
        e.decision(30, int(mt not in (1, 2)))
        if mt in (1, 2):
            e.decision(32, mt - 1)
            return
        extra = None
        if mt is None:
            bits = 13
        elif mt <= 10:
            bits = mt - 3
        elif mt == 11:
            bits = 14
        elif mt == 22:
            bits = 15
        else:
            bits, extra = (mt + 4) >> 1, (mt + 4) & 1
        e.decision(31, (bits >> 3) & 1)
        for k in (2, 1, 0):
            e.decision(32, (bits >> k) & 1)
        if extra is not None:
            e.decision(32, extra)
        if mt is None:
            self._mb_type_i(32, 0, kind, t)

    def sub_mb_type_b(self, sub: int) -> None:
        e = self.e
        e.decision(36, int(sub != 0))
        if sub == 0:
            return
        e.decision(37, int(sub > 2))
        if sub <= 2:
            e.decision(39, sub - 1)
            return
        e.decision(38, int(sub >= 7))
        if sub >= 7:
            e.decision(39, int(sub >= 11))
            if sub >= 11:
                e.decision(39, sub - 11)
                return
            rem = sub - 7
        else:
            rem = sub - 3
        e.decision(39, rem >> 1)
        e.decision(39, rem & 1)

    def transform_8x8(self, mx, my, flag: bool) -> None:
        inc = sum(1 for a in (self._addr(mx - 1, my), self._addr(mx, my - 1))
                  if a is not None and self.pic.t8[a])
        self.e.decision(399 + inc, int(flag))

    def pred_mode(self, mode: int, pred: int) -> None:
        self.e.decision(68, int(mode == pred))
        if mode != pred:
            rem = mode if mode < pred else mode - 1
            for i in range(3):
                self.e.decision(69, (rem >> i) & 1)

    def chroma_mode(self, mx, my, mode: int) -> None:
        pic = self.pic
        inc = sum(1 for a in (self._addr(mx - 1, my), self._addr(mx, my - 1))
                  if a is not None and pic.intra(a) and pic.kind[a] != "PCM" and pic.cmode[a])
        self.e.decision(64 + inc, int(mode > 0))
        if mode:
            self.e.decision(67, int(mode > 1))
            if mode > 1:
                self.e.decision(67, int(mode > 2))

    def cbp(self, mx, my, cbp: int) -> None:
        pic = self.pic

        def bit(nx, ny, b8):
            a = self._addr(nx, ny)
            return 1 if a is None else (pic.cbp[a] >> b8) & 1
        for b8 in range(4):
            x8, y8 = b8 & 1, b8 >> 1
            a = (cbp >> (b8 - 1)) & 1 if x8 else bit(mx - 1, my, b8 + 1)
            c = (cbp >> (b8 - 2)) & 1 if y8 else bit(mx, my - 1, b8 + 2)
            self.e.decision(73 + (1 - a) + 2 * (1 - c), (cbp >> b8) & 1)

        def chroma(nx, ny):
            a = self._addr(nx, ny)
            return 0 if a is None else pic.cbp[a] >> 4
        ca, cb = chroma(mx - 1, my), chroma(mx, my - 1)
        self.e.decision(77 + int(ca != 0) + 2 * int(cb != 0), int(cbp >> 4 != 0))
        if cbp >> 4:
            self.e.decision(81 + int(ca == 2) + 2 * int(cb == 2), int(cbp >> 4 == 2))

    def dqp(self, dq: int) -> None:
        e = self.e
        e.decision(60 + int(self.last_dqp != 0), int(dq != 0))
        if dq:
            k = 2 * dq - 1 if dq > 0 else -2 * dq
            for i in range(1, k):
                e.decision(62 if i == 1 else 63, 1)
            e.decision(62 if k == 1 else 63, 0)
        self.last_dqp = dq

    def ref_idx(self, mx, my, x, y, w, h, ref: int, lst: int = 0) -> None:
        pic = self.pic

        def cond(nx, ny):
            a, k = self._cover(mx, my, nx, ny)
            return int(a is not None and pic.kind[a] in ("P", "B") and not pic.direct[a][k]
                       and pic.ref[a][lst][k] > 0)
        ctx = 54 + cond(x - 1, y) + 2 * cond(x, y - 1)
        for i in range(ref + 1):
            self.e.decision(ctx, int(i < ref))
            ctx = 58 if i == 0 else 59
        addr = my * pic.mbw + mx
        for by in range(y // 4, (y + h) // 4):
            for bx in range(x // 4, (x + w) // 4):
                pic.ref[addr][lst][by * 4 + bx] = ref

    def mvd(self, mx, my, x, y, w, h, d, lst: int = 0) -> None:
        pic, e = self.pic, self.e
        addr = my * pic.mbw + mx
        for c in range(2):
            def amvd(nx, ny):
                a, k = self._cover(mx, my, nx, ny)
                return int(pic.mvd[a][lst][k][c]) if a is not None and pic.kind[a] in ("P", "B") \
                    else 0
            s = amvd(x - 1, y) + amvd(x, y - 1)
            base, v = (47 if c else 40), abs(d[c])
            e.decision(base + (0 if s < 3 else 2 if s > 32 else 1), int(v != 0))
            if v:
                ctx = 3
                for i in range(1, min(v, 9)):
                    e.decision(base + ctx, 1)
                    ctx = min(ctx + 1, 6)
                if v < 9:
                    e.decision(base + ctx, 0)
                else:
                    e.exp_golomb(v - 9, 3)
                e.bypass(int(d[c] < 0))
        for by in range(y // 4, (y + h) // 4):
            for bx in range(x // 4, (x + w) // 4):
                pic.mvd[addr][lst][by * 4 + bx] = [min(abs(d[0]), 255), min(abs(d[1]), 255)]

    def sub_mb_type(self, sub: int) -> None:
        e = self.e
        e.decision(21, int(sub == 0))
        if sub:
            e.decision(22, int(sub > 1))
            if sub > 1:
                e.decision(23, int(sub == 2))

    # -- residual blocks -------------------------------------------------------

    def block(self, cat: int, cbf, coef) -> int:
        """residual_block_cabac of ``coef`` (levels in scan order); ``cbf``
        coded_block_flag's ctxIdxInc (None: not coded, cat 5)."""
        e, t = self.e, tables()
        nzpos = [i for i, v in enumerate(coef) if v]
        if cbf is not None:
            e.decision(85 + cbf, int(bool(nzpos)))
        if not nzpos:
            return 0
        last, n = nzpos[-1], len(coef)
        for i in range(n - 1):
            sig = int(coef[i] != 0)
            inc = t.sig8[i] if cat == 5 else min(i, 2) if cat == 3 else i
            e.decision(_SIG[cat] + inc, sig)
            if sig:
                inc = t.last8[i] if cat == 5 else min(i, 2) if cat == 3 else i
                e.decision(_LAST[cat] + inc, int(i == last))
                if i == last:
                    break
        gt1 = eq1 = 0
        for i in reversed(nzpos):
            level = abs(coef[i])
            e.decision(_ABS[cat] + (0 if gt1 else min(4, 1 + eq1)), int(level > 1))
            if level > 1:
                inc = _ABS[cat] + 5 + min(4 - (cat == 3), gt1)
                for _ in range(2, min(level, 15)):
                    e.decision(inc, 1)
                if level < 15:
                    e.decision(inc, 0)
                else:
                    e.exp_golomb(level - 15, 0)
                gt1 += 1
            else:
                eq1 += 1
            e.bypass(int(coef[i] < 0))
        return len(nzpos)

    def _dc_flag(self, nx, ny, bit):
        a = self._addr(nx, ny)
        if a is None:
            return None
        return 1 if self.pic.kind[a] == "PCM" else (self.pic.dcf[a] >> bit) & 1

    def coded_block(self, mx, my, cat: int, bx: int, by: int, plane: int, coef) -> int:
        pic = self.pic
        addr = my * pic.mbw + mx
        if cat == 5:
            return self.block(5, None, coef)
        if cat in (0, 3):
            a, c = self._dc_flag(mx - 1, my, plane), self._dc_flag(mx, my - 1, plane)
        else:
            a, c = (pic.nz_at(mx, my, bx - 1, by, plane), pic.nz_at(mx, my, bx, by - 1, plane))
            a, c = (None if v < 0 else int(v > 0) for v in (a, c))
        intra = int(pic.intra(addr))
        a, c = (intra if v is None else v for v in (a, c))
        n = self.block(cat, 4 * cat + a + 2 * c, coef)
        if cat in (0, 3) and n:
            pic.dcf[addr] |= 1 << plane
        return n

    def residual(self, mx, my, d, cbp, i16) -> None:
        pic = self.pic
        addr = my * pic.mbw + mx
        nz = pic.nz[addr]
        nz[:] = 0
        if i16:
            self.coded_block(mx, my, 0, 0, 0, 0, d["dc"])
        for b8 in range(4):
            if not cbp & (1 << b8):
                continue
            if d.get("t8"):
                n = self.coded_block(mx, my, 5, 0, 0, 0, d["luma8"][b8])
                for i4 in range(4):
                    nz[_zy(4 * b8 + i4) * 4 + _zx(4 * b8 + i4)] = n
                continue
            for i4 in range(4):
                blk = 4 * b8 + i4
                bx, by = _zx(blk), _zy(blk)
                if i16:
                    nz[by * 4 + bx] = self.coded_block(mx, my, 1, bx, by, 0, d["ac"][blk])
                else:
                    nz[by * 4 + bx] = self.coded_block(mx, my, 2, bx, by, 0, d["luma"][blk])
        if cbp & 0x30:
            for c in range(2):
                self.coded_block(mx, my, 3, 0, 0, c + 1, d["cdc"][c])
        if cbp >> 4 == 2:
            for c in range(2):
                for k in range(4):
                    nz[16 + 4 * c + k] = self.coded_block(mx, my, 4, k & 1, k >> 1, c + 1,
                                                          d["cac"][c][k])

    def _b_macroblock(self, mx, my, d: dict, num_ref) -> int:
        """A B macroblock's prediction, cbp, transform flag, qp delta and
        residual; its mb_qp_delta returned."""
        pic = self.pic
        addr = my * pic.mbw + mx
        mt = d["mb_type"]
        parts = []  # (x, y, w, h, lists) of each partition or sub-partition, in order
        if mt == 0:
            pic.direct[addr] = True
        elif mt == 22:
            for sub in d["sub"]:
                self.sub_mb_type_b(sub)
            for k, sub in enumerate(d["sub"]):
                x8, y8 = (k & 1) * 8, (k >> 1) * 8
                if sub == 0:
                    for by in range(y8 // 4, y8 // 4 + 2):
                        pic.direct[addr][by * 4 + x8 // 4:by * 4 + x8 // 4 + 2] = True
                    continue
                lists, w, h = B_SUB[sub]
                for y in range(0, 8, h):
                    for x in range(0, 8, w):
                        parts.append((x8 + x, y8 + y, w, h, lists, k))
        else:
            parts = [p + (i,) for i, p in enumerate(b_parts(mt))]
        # ref_idx: by list, for each partition (8x8 of B_8x8) predicting from it
        for lst in range(2):
            seen = set()
            for x, y, w, h, lists, k in parts:
                if not lists & (1 << lst) or k in seen:
                    continue
                seen.add(k)
                wx, hy = (8, 8) if mt == 22 else (w, h)
                xx, yy = ((k & 1) * 8, (k >> 1) * 8) if mt == 22 else (x, y)
                ref = d["refs"][lst][k]
                if num_ref[lst] > 1:
                    self.ref_idx(mx, my, xx, yy, wx, hy, ref, lst)
                else:
                    for by in range(yy // 4, (yy + hy) // 4):
                        for bx in range(xx // 4, (xx + wx) // 4):
                            pic.ref[addr][lst][by * 4 + bx] = ref
            for x, y, w, h, lists, k in parts:  # blocks that do not predict from the list
                if not lists & (1 << lst):
                    for by in range(y // 4, (y + h) // 4):
                        for bx in range(x // 4, (x + w) // 4):
                            pic.ref[addr][lst][by * 4 + bx] = -1
        for lst in range(2):
            mvds = iter(d["mvd"][lst])
            for x, y, w, h, lists, k in parts:
                if lists & (1 << lst):
                    self.mvd(mx, my, x, y, w, h, next(mvds), lst)
        cbp = d["cbp"]
        self.cbp(mx, my, cbp)
        if (cbp & 15) and self.t8_mode and _b_t8_allowed(d, {"direct8x8": self.direct8x8}):
            self.transform_8x8(mx, my, d["t8"])
            pic.t8[addr] = bool(d["t8"])
        pic.cbp[addr] = cbp
        dq = 0
        if cbp:
            dq = d["dqp"]
            self.dqp(dq)
        self.residual(mx, my, d, cbp, False)
        return dq

    def macroblock(self, mx, my, d: dict, slice_type: str, num_ref: int) -> None:
        """One macroblock of description ``d`` (``RandomPicture.describe``),
        not skipped; the picture learns what later contexts read."""
        pic = self.pic
        addr = my * pic.mbw + mx
        kind = d["kind"]
        pic.slice[addr], pic.kind[addr] = pic.cur_slice, kind
        pic.cbp[addr], pic.t8[addr], pic.cmode[addr], pic.dcf[addr] = 0, False, 0, 0
        pic.mvd[addr], pic.ref[addr], pic.direct[addr] = 0, 0, False
        pic.btype[addr] = d.get("mb_type", -1) if kind == "B" else -1
        self.mb_type(mx, my, d, slice_type)
        dq = 0
        if kind == "PCM":
            self.e.drain(self.b)
            self.b.align_zero()
            for v in d["pcm"]:
                self.b.u(int(v), 8)
            self.e.start()
            pic.nz[addr], pic.cbp[addr], pic.dcf[addr] = 16, 47, 7
            self.last_dqp = 0
            return
        if kind == "B":
            dq = self._b_macroblock(mx, my, d, num_ref)
        elif kind == "P":
            mt, refs = d["mb_type"], d["refs"]
            parts = []
            if mt < 3:
                w, h = (8 if mt == 2 else 16), (8 if mt == 1 else 16)
                for k in range(len(refs)):
                    x, y = (8 * k if mt == 2 else 0), (8 * k if mt == 1 else 0)
                    if num_ref > 1:
                        self.ref_idx(mx, my, x, y, w, h, refs[k])
                    parts.append((x, y, w, h))
            else:
                for s in d["sub"]:
                    self.sub_mb_type(s)
                for k in range(4):
                    if num_ref > 1:
                        self.ref_idx(mx, my, (k & 1) * 8, (k >> 1) * 8, 8, 8, refs[k])
                for k in range(4):
                    w = 8 if d["sub"][k] in (0, 1) else 4
                    h = 8 if d["sub"][k] in (0, 2) else 4
                    for y in range(0, 8, h):
                        for x in range(0, 8, w):
                            parts.append(((k & 1) * 8 + x, (k >> 1) * 8 + y, w, h))
            for (x, y, w, h), mv in zip(parts, d["mvd"]):
                self.mvd(mx, my, x, y, w, h, mv)
            cbp = d["cbp"]
            self.cbp(mx, my, cbp)
            small = mt >= 3 and any(d["sub"])
            if (cbp & 15) and self.t8_mode and not small:
                self.transform_8x8(mx, my, d["t8"])
                pic.t8[addr] = bool(d["t8"])
            pic.cbp[addr] = cbp
            if cbp:
                dq = d["dqp"]
                self.dqp(dq)
            self.residual(mx, my, d, cbp, False)
        elif kind in ("I4", "I8"):
            if self.t8_mode:
                self.transform_8x8(mx, my, kind == "I8")
                pic.t8[addr] = kind == "I8"
            cur = [-1] * 16
            n = 4 if kind == "I8" else 16
            for k in range(n):
                blk = 4 * k if kind == "I8" else k
                bx, by = _zx(blk), _zy(blk)
                pred = pic.predicted_mode(mx, my, bx, by, cur)
                self.pred_mode(d["modes"][k], pred)
                s = 2 if kind == "I8" else 1
                for y in range(by, by + s):
                    for x in range(bx, bx + s):
                        cur[y * 4 + x] = d["modes"][k]
            pic.ipred[addr] = cur
            self.chroma_mode(mx, my, d["cmode"])
            pic.cmode[addr] = d["cmode"]
            cbp = d["cbp"]
            self.cbp(mx, my, cbp)
            pic.cbp[addr] = cbp
            if cbp:
                dq = d["dqp"]
                self.dqp(dq)
            self.residual(mx, my, d, cbp, False)
        else:  # I16
            self.chroma_mode(mx, my, d["cmode"])
            pic.cmode[addr] = d["cmode"]
            pic.cbp[addr] = d["cbp"]
            dq = d["dqp"]
            self.dqp(dq)
            self.residual(mx, my, d, d["cbp"], True)
        self.last_dqp = dq


# --- random syntax ---------------------------------------------------------------


def _levels(rng, n: int, big: float = 0.15, dense: float = 0.5) -> list:
    """``n`` levels in scan order: mostly zeros and small, some of every size."""
    out = [0] * n
    count = int(rng.integers(0, n + 1)) if rng.random() < dense else int(rng.integers(0, 4))
    for p in rng.choice(n, size=min(count, n), replace=False):
        r = rng.random()
        mag = 1 if r < 0.45 else int(rng.integers(2, 5)) if r < 0.8 else \
            int(rng.integers(5, 40)) if r < 1 - big / 3 else int(rng.integers(40, 2000))
        out[int(p)] = mag * int(rng.choice([-1, 1]))
    return out


def _shrink(levels: list, fits) -> list:
    """``levels`` halved until ``fits(levels)``."""
    while not fits(levels):
        levels = [int(np.fix(v / 2)) for v in levels]
    return levels


class RandomPicture:
    """Random macroblock descriptions for one slice at a time."""

    def __init__(self, rng, o: dict, pic: Picture):
        self.rng, self.o, self.pic = rng, o, pic

    def _fits4(self, raster, qp, dc=0) -> bool:
        d = deq4(np.asarray(raster), qp)
        d[0] = dc if dc is not None else d[0]
        return int(np.abs(d).sum()) <= 30000

    def _block4(self, qp, n=16, dc=None) -> list:
        zz = tables().zigzag4
        start = 16 - n

        def fits(lv):
            raster = np.zeros(16, int)
            for k, v in enumerate(lv):
                raster[zz[k + start]] = v
            if dc is not None:
                raster[0] = 0
            return self._fits4(raster, qp, dc)
        return _shrink(_levels(self.rng, n), fits)

    def _block8(self, qp) -> list:
        zz = tables().zigzag8

        def fits(lv):
            raster = np.zeros(64, int)
            for k, v in enumerate(lv):
                raster[zz[k]] = v
            return int(np.abs(deq8(raster, qp)).sum()) <= 7000
        return _shrink(_levels(self.rng, 64), fits)

    def _chroma(self, d: dict, qp: int, cbp_c: int) -> None:
        rng, o = self.rng, self.o
        d["cdc"], d["cac"] = [[0] * 4, [0] * 4], [[[0] * 15 for _ in range(4)] for _ in range(2)]
        for c in range(2):
            qpc = chroma_qp(qp, o["cqp"][c])
            if cbp_c:
                d["cdc"][c] = _shrink(_levels(rng, 4), lambda lv: int(np.abs(chroma_dc(lv, qpc))
                                                                      .max()) <= 8000)
            dcs = chroma_dc(d["cdc"][c], qpc)
            if cbp_c == 2:
                for k in range(4):
                    d["cac"][c][k] = self._block4(qpc, 15, int(dcs[k]))

    def _mvd(self) -> tuple:
        lim = self.o["mvd"]
        if self.o["far_mv"] and self.rng.random() < 0.1:
            return tuple(int(v) for v in self.rng.integers(-400, 401, 2))
        return int(self.rng.integers(-lim, lim + 1)), int(self.rng.integers(-lim, lim + 1))

    def _describe_b(self, d: dict, cbp: int, num_ref) -> None:
        """A B macroblock's mb_type, sub_mb_types, ref_idx and mvd by list."""
        rng, o = self.rng, self.o
        mt = int(rng.choice(o["b_types"] or range(23)))
        d["mb_type"] = mt
        refs, mvds = [[], []], [[], []]
        if mt == 22:
            d["sub"] = [int(rng.choice(o["b_sub"] or range(13))) for _ in range(4)]
            for lst in range(2):
                for sub in d["sub"]:
                    use = sub and B_SUB[sub][0] & (1 << lst)
                    refs[lst].append(int(rng.integers(0, num_ref[lst])) if use else -1)
                    if use:
                        mvds[lst] += [self._mvd() for _ in range((8 // B_SUB[sub][1])
                                                                  * (8 // B_SUB[sub][2]))]
        elif mt:
            for lst in range(2):
                for *_, lists in b_parts(mt):
                    use = lists & (1 << lst)
                    refs[lst].append(int(rng.integers(0, num_ref[lst])) if use else -1)
                    if use:
                        mvds[lst].append(self._mvd())
        d["refs"], d["mvd"] = refs, mvds
        d["t8"] = bool(o["t8"] and (cbp & 15) and _b_t8_allowed(d, o) and rng.random() < 0.5)

    def describe(self, mx: int, my: int, kind: str, qp: int, num_ref) -> dict:
        """A random macroblock of ``kind`` at ``qp`` (the QP before its
        mb_qp_delta); d["qp"] is the one after."""
        rng, o, pic = self.rng, self.o, self.pic
        d = dict(kind=kind)
        dqp = 0
        lo, hi = o["qp_range"]
        if rng.random() < 0.5:
            dqp = int(np.clip(int(rng.integers(lo, hi + 1)) - qp, -26, 25))
        if rng.random() < 0.03:
            dqp = int(rng.choice([-26, 25]))  # a wrap-around of QPY
        if kind == "PCM":
            d["pcm"] = rng.integers(0, 256, 384)
            d["qp"] = qp
            return d
        if kind == "I16":
            top, left, tl = pic.avail_intra(mx, my - 1), pic.avail_intra(mx - 1, my), \
                pic.avail_intra(mx - 1, my - 1)
            d["mode"] = int(rng.choice(valid_16_modes(top, left, tl)))
            d["cmode"] = int(rng.choice(valid_chroma_modes(top, left, tl)))
            cbp = (int(rng.integers(0, 3)) << 4) | (15 if rng.random() < 0.5 else 0)
            d["cbp"], d["dqp"] = cbp, dqp
            q = (qp + dqp + 52) % 52
            d["qp"] = q

            def dc_fits(lv):
                raster = np.zeros(16, int)
                for k, v in enumerate(lv):
                    raster[tables().zigzag4[k]] = v
                return int(np.abs(luma_dc(raster, q)).max()) <= 8000
            d["dc"] = _shrink(_levels(rng, 16), dc_fits)
            raster = np.zeros(16, int)
            for k, v in enumerate(d["dc"]):
                raster[tables().zigzag4[k]] = v
            dcs = luma_dc(raster, q)
            d["ac"] = [[0] * 15 for _ in range(16)]
            if cbp & 15:
                for blk in range(16):
                    bx, by = _zx(blk), _zy(blk)
                    d["ac"][blk] = self._block4(q, 15, int(dcs[by * 4 + bx]))
            self._chroma(d, q, cbp >> 4)
            return d
        cbp = int(rng.integers(0, 48))
        if rng.random() < 0.2:
            cbp = 0
        if kind in ("I4", "I8"):
            n = 4 if kind == "I8" else 16
            modes, cur = [], [-1] * 16
            top, left, tl = pic.avail_intra(mx, my - 1), pic.avail_intra(mx - 1, my), \
                pic.avail_intra(mx - 1, my - 1)
            for k in range(n):
                blk = 4 * k if kind == "I8" else k
                bx, by = _zx(blk), _zy(blk)
                bt, bl, btl, _ = pic.block_avail(mx, my, bx, by, 8 if kind == "I8" else 4)
                pred = pic.predicted_mode(mx, my, bx, by, cur)
                ok = valid_nxn_modes(bt, bl, btl)
                m = pred if pred in ok and rng.random() < 0.3 else int(rng.choice(ok))
                modes.append(m)
                s = 2 if kind == "I8" else 1
                for y in range(by, by + s):
                    for x in range(bx, bx + s):
                        cur[y * 4 + x] = m
            d["modes"] = modes
            d["cmode"] = int(rng.choice(valid_chroma_modes(top, left, tl)))
            d["t8"] = kind == "I8"
        elif kind == "B":
            self._describe_b(d, cbp, num_ref)
        else:  # P
            mb_type = int(rng.choice(o["p_types"] or [0, 1, 2, 3] + (
                [4] if num_ref > 1 and not o.get("cabac") else [])))
            d["mb_type"] = mb_type
            if mb_type < 3:
                nparts = 1 if mb_type == 0 else 2
                d["refs"] = [int(rng.integers(0, num_ref)) for _ in range(nparts)]
                nmv = nparts
            else:
                d["sub"] = [int(rng.choice(4, p=[0.4, 0.2, 0.2, 0.2])) for _ in range(4)]
                d["refs"] = [int(rng.integers(0, num_ref)) for _ in range(4)] \
                    if mb_type == 3 else [0] * 4
                nmv = sum((1, 2, 2, 4)[s] for s in d["sub"])
            lim = o["mvd"]
            d["mvd"] = [(int(rng.integers(-lim, lim + 1)), int(rng.integers(-lim, lim + 1)))
                        for _ in range(nmv)]
            if o["far_mv"] and rng.random() < 0.1:
                d["mvd"][0] = tuple(int(v) for v in rng.integers(-400, 401, 2))
            small = mb_type >= 3 and any(d["sub"])
            d["t8"] = bool(o["t8"] and (cbp & 15) and not small and rng.random() < 0.5)
        d["cbp"], d["dqp"] = cbp, (dqp if cbp else 0)
        q = (qp + d["dqp"] + 52) % 52
        d["qp"] = q
        if d.get("t8"):
            d["luma8"] = [self._block8(q) if cbp & (1 << b8) else [0] * 64 for b8 in range(4)]
            for b8, lv in enumerate(d["luma8"]):  # CABAC codes no coded_block_flag for these:
                if o.get("cabac") and cbp & (1 << b8) and not any(lv):  # a coded one holds a level
                    lv[int(rng.integers(0, 64))] = int(rng.choice([-1, 1]))
        else:
            d["luma"] = [self._block4(q) if cbp & (1 << (blk >> 2)) else [0] * 16
                         for blk in range(16)]
        self._chroma(d, q, cbp >> 4)
        return d


# --- streams ----------------------------------------------------------------------


class _CavlcSink:
    """A slice's macroblocks under CAVLC: skipped ones counted into
    mb_skip_run."""

    def __init__(self, b: Bits, o: dict):
        self.b, self.o, self.run = b, o, 0

    def skip(self, pic: Picture, mx: int, my: int) -> None:
        addr = my * pic.mbw + mx
        pic.slice[addr], pic.kind[addr] = pic.cur_slice, "skip"
        pic.nz[addr] = 0
        self.run += 1

    def mb(self, pic: Picture, mx: int, my: int, d: dict, stype: str, num_ref) -> None:
        if stype in ("P", "B"):
            self.b.ue(self.run)
            self.run = 0
        write_mb(self.b, pic, mx, my, d, stype, self.o, num_ref)

    def end(self) -> None:
        if self.run:
            self.b.ue(self.run)


class _CabacSink:
    """A slice's macroblocks under CABAC: mb_skip_flag in P slices and
    end_of_slice_flag after each macroblock."""

    def __init__(self, cs: CabacSlice, count: int, b_slice: bool = False):
        self.cs, self.left, self.b_slice = cs, count, b_slice

    def skip(self, pic: Picture, mx: int, my: int) -> None:
        self.cs.skip(mx, my, True, self.b_slice)
        self._next()

    def mb(self, pic: Picture, mx: int, my: int, d: dict, stype: str, num_ref) -> None:
        if stype in ("P", "B"):
            self.cs.skip(mx, my, False, self.b_slice)
        self.cs.macroblock(mx, my, d, stype, num_ref)
        self._next()

    def _next(self) -> None:
        self.left -= 1
        self.cs.end(self.left == 0)

    def end(self) -> None:
        assert self.left == 0


class StreamWriter:
    """Pictures of one stream, each a list of NAL units, with the reference
    bookkeeping (sliding window, MMCO 1, list modification) the syntax
    needs."""

    def __init__(self, o: dict, seed: int):
        self.o = o
        self.rng = np.random.default_rng(seed)
        self.refs = []  # frame_num of each short-term reference, oldest first
        self.frame_num = 0
        self.prev_ref_frame_num = 0
        self.idr_count = 0
        self.poc_lsb = 0
        self.n = 0
        self.last_nonref = False
        self.variant = 0
        self.ref_info = {}  # frame_num -> poc, uid, the uids held when it was decoded
        self.cur_poc = 0
        self.lists = []  # the last slice's reference lists (frame_nums)

    def parameter_sets(self) -> list:
        o = self.o
        self.variant = self.idr_count  # what the pictures up to the next sets use
        so = dict(o)
        if o["inband"] == "colour" and self.variant % 2:  # the SPS's VUI changes
            so["vui"] = dict(o["vui"] or {}, full_range=not (o["vui"] or {}).get("full_range"))
        out = [nal(3, 7, sps(so, o.get("sps_id", 0)))]
        for pid in o["pps_ids"]:
            out.append(nal(3, 8, pps(self._pps_of(pid), pid, o.get("sps_id", 0))))
        return out

    def _pps_of(self, pid):
        """The options of PPS ``pid``: each id its own QP and chroma offsets,
        and with ``inband`` "change" others after each IDR picture (with
        "colour" the SPS's full range flips instead)."""
        o = dict(self.o)
        k = list(self.o["pps_ids"]).index(pid)
        if self.o["inband"] == "change":
            k += self.variant % 3
        if k:
            o["init_qp"] = 20 + 3 * k
            o["cqp"] = [self.o["cqp"][0] - k, self.o["cqp"][1] + k]
        return o

    def picture(self, idr: bool, body=None, kind: str = "P", poc=None, ref_idc=None) -> list:
        """The NAL units of the next picture (random macroblocks unless
        ``body(writer, slice_args)`` gives them): ``kind`` "P" or "B" for a
        non-IDR picture, ``poc`` its picture order count from the last IDR
        picture's (else the stream's ``poc_step`` on), ``ref_idc`` its
        nal_ref_idc (else drawn by ``nonref``)."""
        o, rng = self.o, self.rng
        units = []
        if o["extra_nals"]:
            units.append(nal(0, 9, bytes([(0 if idr else 1) << 5 | 0x10])))  # AUD
        if idr and self.n and o["inband"]:  # the parameter sets again, in band
            units += self.parameter_sets()
        if o["extra_nals"]:
            units.append(nal(0, 6, bytes([5, 17]) + bytes(range(16)) + b"\x07\x80"))  # SEI
        max_fn = 1 << o["log2_max_frame_num"]
        if idr:
            self.refs = []
            self.ref_info = {}
            self.frame_num = 0
            self.poc_lsb = 0
            self.cur_poc = 0
        else:
            skip = 2 if o["gap_at"] == self.n else 1  # a gap in frame_num
            self.frame_num = (self.prev_ref_frame_num + skip) % max_fn
        if ref_idc is None:
            ref_idc = 3
            if not idr and o["nonref"] and rng.random() < o["nonref"] and \
                    not (o["poc_type"] in (1, 2) and self.last_nonref):  # else a repeated POC
                ref_idc = 0
        self.last_nonref = ref_idc == 0
        if not idr:
            if poc is not None:
                step = poc - self.cur_poc
            else:
                step = o["poc_step"] if isinstance(o["poc_step"], int) else \
                    int(rng.choice(o["poc_step"]))
                if o["poc_drop_at"] == self.n:  # output order other than decoding order
                    step = -1
            self.poc_lsb = (self.poc_lsb + step) % (1 << o["log2_max_poc_lsb"])
            self.cur_poc += step
        pid = int(rng.choice(o["pps_ids"]))
        po = self._pps_of(pid)
        mbw, mbh = o["mbw"], o["mbh"]
        total = mbw * mbh
        cuts = sorted(set(int(v) for v in rng.integers(1, total, o["slices"] - 1))) \
            if o["slices"] > 1 and total > 1 else []
        bounds = [0] + cuts + [total]
        pic = Picture(mbw, mbh, o["constrained_intra"])
        self.pic_nref = None  # the list lengths of the picture's slices, drawn by the first
        # the reference marking of the picture, the same in every slice
        mmco = []
        if ref_idc and not idr and o["mmco"] and self.refs and rng.random() < 0.5:
            need = max(len(self.refs) + 1 - max(o["max_ref"], 1), 0)
            k = max(need, int(rng.integers(1, len(self.refs) + 1)))
            mmco = list(rng.choice(self.refs, size=k, replace=False))
        for si in range(len(bounds) - 1):
            pic.cur_slice = si
            units.append(self._slice(idr, ref_idc, pid, po, pic, bounds[si], bounds[si + 1],
                                     mmco, body, kind))
        if o["extra_nals"]:
            units.append(nal(0, 12, b"\xff" * 5 + b"\x80"))  # filler data
        # marking, as the decoder does it
        if ref_idc:
            held = {self.ref_info[f]["uid"] for f in self.refs}
            if mmco:
                self.refs = [f for f in self.refs if f not in mmco]
            elif not idr and len(self.refs) >= max(o["max_ref"], 1):
                wrap = lambda f: f - max_fn if f > self.frame_num else f  # noqa: E731
                self.refs.remove(min(self.refs, key=wrap))
            self.refs.append(self.frame_num)
            self.ref_info[self.frame_num] = dict(poc=self.cur_poc, uid=self.n, dpb=held)
            self.prev_ref_frame_num = self.frame_num
        self.n += 1
        self.idr_count += idr  # parameter sets and slices of one IDR picture agree
        return units

    def _pic_num(self, f):
        return f - (1 << self.o["log2_max_frame_num"]) if f > self.frame_num else f

    def _lists(self, stype: str) -> list:
        """The initial reference lists (frame_nums) of a P or B slice."""
        if stype == "P":
            return [sorted(self.refs, key=self._pic_num, reverse=True)]
        poc = lambda f: self.ref_info[f]["poc"]  # noqa: E731
        before = sorted([f for f in self.refs if poc(f) <= self.cur_poc], key=poc, reverse=True)
        after = sorted([f for f in self.refs if poc(f) > self.cur_poc], key=poc)
        l0, l1 = before + after, after + before
        if len(l1) > 1 and l1 == l0:
            l1[0], l1[1] = l1[1], l1[0]
        return [l0, l1]

    def _modify(self, b: Bits, lst: list, n: int) -> list:
        """ref_pic_list_modification of one list: drawn, written, applied."""
        o, rng = self.o, self.rng
        if not (o["modify"] and rng.random() < 0.6):
            b.flag(False)
            return lst[:n]
        b.flag(True)
        max_fn = 1 << o["log2_max_frame_num"]
        pred = self.frame_num
        out = lst[:n]
        for idx in range(int(rng.integers(1, n + 1))):
            f = int(rng.choice(self.refs))
            target = self._pic_num(f)
            no_wrap = target + max_fn if target < 0 else target
            if rng.random() < 0.5:
                diff = (pred - no_wrap) % max_fn or max_fn
                b.ue(0)
            else:
                diff = (no_wrap - pred) % max_fn or max_fn
                b.ue(1)
            b.ue(diff - 1)
            pred = no_wrap
            out = (out[:idx] + [f] + [g for g in out[idx:] if g != f])[:n]
        b.ue(3)
        return out

    def _weights(self, b: Bits, num_ref: list) -> None:
        """pred_weight_table: random denominators, weights (negative ones too)
        and offsets, within what libavcodec and the standard take; or with
        ``fixed_weights`` (denominator, weight, offset) those for every
        reference's luma, its chroma left at the default."""
        rng = self.rng
        if self.o.get("fixed_weights"):
            den, wt, off = self.o["fixed_weights"]
            b.ue(den)
            b.ue(0)
            for n in num_ref:
                for _ in range(n):
                    b.flag(True)
                    b.se(wt)
                    b.se(off)
                    b.flag(False)
            return
        dl, dc = int(rng.integers(0, 8)), int(rng.integers(0, 8))
        b.ue(dl)
        b.ue(dc)
        chosen = []
        for n in num_ref:
            row = []
            for _ in range(n):
                w = []
                for den in (dl, dc, dc):
                    if rng.random() < 0.15:
                        w.append((int(rng.integers(-20, 0)), int(rng.integers(-30, 31))))
                    else:
                        w.append((min(127, (1 << den) + int(rng.integers(-(1 << den) // 2 - 1,
                                                                        (1 << den) // 2 + 2))),
                                  int(rng.integers(-20, 21))))
                luma, chroma = rng.random() < 0.6, rng.random() < 0.5
                row.append((luma, chroma, w))
            chosen.append(row)
        if len(num_ref) == 2:  # -128 <= w0 + w1 <= 127 (128 below denominator 7)
            for r0 in chosen[0]:
                for r1 in chosen[1]:
                    for i, den in enumerate((dl, dc, dc)):
                        lim = 127 if den == 7 else 128
                        if (i == 0 and not (r0[0] and r1[0])) or (i and not (r0[1] and r1[1])):
                            continue
                        while r0[2][i][0] + r1[2][i][0] > lim:
                            r1[2][i] = (r1[2][i][0] - 1, r1[2][i][1])
                        while r0[2][i][0] + r1[2][i][0] < -128:
                            r1[2][i] = (r1[2][i][0] + 1, r1[2][i][1])
        for row in chosen:
            for luma, chroma, w in row:
                b.flag(luma)
                if luma:
                    b.se(w[0][0])
                    b.se(w[0][1])
                b.flag(chroma)
                if chroma:
                    for c in (1, 2):
                        b.se(w[c][0])
                        b.se(w[c][1])

    def _slice(self, idr, ref_idc, pid, po, pic, first, end, mmco, body, kind="P") -> bytes:
        o, rng = self.o, self.rng
        b = Bits()
        stype = "I" if idr or (kind == "P" and o["slice_i_in_p"] and rng.random() < 0.2) \
            else kind
        b.ue(first)
        code = 2 if stype == "I" else 1 if stype == "B" else \
            {"B": 1, "SP": 3, "SI": 4}.get(o["force_slice_type"], 0)
        b.ue(code + (5 if rng.random() < 0.5 else 0))
        b.ue(pid)
        b.u(self.frame_num, o["log2_max_frame_num"])
        if idr:
            b.ue(self.idr_count % 4)
        if o["poc_type"] == 0:
            b.u(self.poc_lsb, o["log2_max_poc_lsb"])
            if po.get("bottom_poc"):  # the POC is the smaller field's: still rising
                b.se(int(rng.integers(-1, 4)) if not idr else 0)
        elif o["poc_type"] == 1 and not o["delta_always_zero"]:
            b.se(0)
            if po.get("bottom_poc"):
                b.se(int(rng.integers(0, 3)))
        if po.get("redundant"):
            b.ue(po.get("redundant_cnt", 0))
        num_ref = po["num_ref_default"]
        lists = []
        if stype == "B":
            init = self._lists("B")
            held = len(self.refs)
            spatial = o["direct"] == "spatial" or (o["direct"] is None and rng.random() < 0.5)
            if not spatial and not self.ref_info[init[1][0]]["dpb"] <= {
                    self.ref_info[f]["uid"] for f in self.refs}:
                spatial = True  # a reference of the co-located picture is gone: spatial
            if self.pic_nref is None:  # one length a list for every slice, as encoders write
                self.pic_nref = list(o.get("b_nref") or [int(rng.integers(1, held + 1)),
                                                         int(rng.integers(1, held + 1))])
            n = list(self.pic_nref)
            if not spatial:  # the co-located picture's references all in list 0, it in list 1
                n[0] = o["temporal_l0"] or held  # (fewer: a damaged stream)
            b.flag(spatial)
            b.flag(True)
            b.ue(n[0] - 1)
            b.ue(n[1] - 1)
            if spatial:
                lists = [self._modify(b, init[0], n[0]), self._modify(b, init[1], n[1])]
            else:  # unmodified: a modification may drop a picture for another's copy
                b.flag(False)
                b.flag(False)
                lists = [init[0][:n[0]], init[1][:n[1]]]
            num_ref = n
            if po.get("bipred_idc") == 1:
                self._weights(b, n)
        elif stype == "P":
            held = len(self.refs)
            want = int(rng.integers(1, held + 1)) if o["override"] else min(num_ref, held)
            if o["bframes"] or o["b_anchor"]:  # a co-located picture: one length for all slices
                if self.pic_nref is None:
                    self.pic_nref = [want]
                want = self.pic_nref[0]
            if o["override"] or num_ref > held:
                b.flag(True)
                b.ue(want - 1)
            else:
                b.flag(False)
            num_ref = want
            lists = [self._modify(b, self._lists("P")[0], num_ref)]
            if po.get("weighted"):
                self._weights(b, [num_ref])
        if ref_idc:
            if idr:
                b.flag(False)
                b.flag(o["long_term_idr"])
            elif o["mmco_op"]:  # one operation other than MMCO 1, with its fields
                b.flag(True)
                b.ue(o["mmco_op"])
                for _ in range({2: 1, 3: 2, 4: 1, 5: 0, 6: 1}[o["mmco_op"]]):
                    b.ue(0)
                b.ue(0)
            elif mmco:
                b.flag(True)
                for f in mmco:
                    b.ue(1)
                    b.ue(self.frame_num - self._pic_num(int(f)) - 1)
                b.ue(0)
            else:
                b.flag(False)
        init_idc = 0
        if po.get("cabac") and stype != "I":
            init_idc = int(rng.integers(0, 3))
            b.ue(init_idc)  # cabac_init_idc
        lo, hi = o["qp_range"]
        qp = int(rng.integers(lo, hi + 1))
        b.se(qp - po["init_qp"])
        if po["deblock_ctrl"]:
            idc = int(rng.choice(o["dbk_idc"]))
            b.ue(idc)
            if idc != 1:
                b.se(int(rng.integers(-6, 7)))
                b.se(int(rng.integers(-6, 7)))
        if po.get("cabac"):
            sink = _CabacSink(CabacSlice(b, pic, stype == "I", init_idc, qp, po["t8"],
                                         o.get("direct8x8", True)), end - first, stype == "B")
        else:
            sink = _CavlcSink(b, po)
        self.lists = lists
        if body is not None:
            body(sink, pic, first, end, stype, qp, num_ref)
        else:
            self._random_mbs(sink, pic, first, end, stype, qp, num_ref, po)
        sink.end()
        return nal(ref_idc, 5 if idr else 1, b.rbsp(stop=not po.get("cabac")))

    def _random_mbs(self, sink, pic, first, end, stype, qp, num_ref, po) -> None:
        o, rng = self.o, self.rng
        gen = RandomPicture(rng, po, pic)
        kinds_i = o["i_types"] or (["I4", "I16"] + (["I8"] if po["t8"] else [])
                                   + (["PCM"] if o["pcm"] else []))
        for addr in range(first, end):
            mx, my = addr % pic.mbw, addr // pic.mbw
            if stype in ("P", "B"):
                r = rng.random()
                if r < 0.2:
                    kind = "skip"
                elif r < 0.35 and o["intra_in_p"]:
                    kind = str(rng.choice(kinds_i))
                else:
                    kind = stype
                if po.get("cabac") and addr == end - 1 and rng.random() < 0.3:
                    kind = "skip"  # a slice that ends on a skipped macroblock
            else:
                kind = str(rng.choice(kinds_i))
            if kind == "skip":
                sink.skip(pic, mx, my)
                continue
            d = gen.describe(mx, my, kind, qp, num_ref)
            sink.mb(pic, mx, my, d, stype, num_ref)
            qp = d["qp"]


def schedule(n: int, gop: int, bframes: int, pyramid: bool = False, rng=None,
             b_ref: float = 0.0, b_anchor: float = 0.0) -> list:
    """(display index, kind, ref_idc or None) of ``n`` pictures in decoding
    order: an IDR picture every ``gop`` (closed groups), anchors ``bframes``
    + 1 apart, each followed by the B pictures before it in display order
    (with ``pyramid`` the middle one first, as a reference); ``b_ref`` the
    chance that another B picture is a reference, ``b_anchor`` that an anchor
    is a B picture (predicted from earlier pictures only)."""
    out = []
    for g in range(0, n, gop):
        end = min(g + gop, n)
        out.append((g, "I", None))
        prev = g
        while prev < end - 1:
            anchor = min(prev + bframes + 1, end - 1)
            kind = "B" if rng is not None and rng.random() < b_anchor else "P"
            out.append((anchor, kind, 3 if kind == "B" else None))
            bs = list(range(prev + 1, anchor))
            if pyramid and len(bs) >= 2:
                mid = bs[len(bs) // 2]
                out.append((mid, "B", 3))
                bs.remove(mid)
            for d in bs:
                ref = rng is not None and rng.random() < b_ref
                out.append((d, "B", 3 if ref else 0))
            prev = anchor
    return out


def random_stream(width: int, height: int, n: int, seed: int, **kw) -> tuple:
    """(samples, options): ``n`` pictures of random syntax, an IDR picture
    every ``gop``, each sample the list of its NAL units (the first holds
    the parameter sets).  With ``bframes`` the samples are in decoding
    order and ``options["display"]`` gives each one's display index."""
    o = options(width, height, **kw)
    w = StreamWriter(o, seed)
    samples = []
    if not o["bframes"] and not o["b_anchor"]:
        for k in range(n):
            units = w.parameter_sets() if k == 0 else []
            samples.append(units + w.picture(k % o["gop"] == 0))
        o["display"] = list(range(n))
        return samples, o
    assert o["poc_type"] == 0, "B pictures here need POC type 0"
    order = schedule(n, o["gop"], o["bframes"], o["pyramid"],
                     np.random.default_rng(seed + 7), o["b_ref"], o["b_anchor"])
    for k, (disp, kind, ref_idc) in enumerate(order):
        units = w.parameter_sets() if k == 0 else []
        g = disp - disp % o["gop"]
        samples.append(units + w.picture(kind == "I", kind=kind, poc=2 * (disp - g),
                                         ref_idc=ref_idc))
    o["display"] = [d for d, _, _ in order]
    return samples, o


# --- an encoder of real content --------------------------------------------------


def smooth_yuv(width: int, height: int, n: int, seed: int, step: int = 4, bit_depth: int = 8):
    """(n, H, W) Y and (n, H/2, W/2) U, V planes of a seeded smooth field
    panning ``step`` pixels a frame (a random field at 1/16 of the size,
    bilinearly upsampled), samples of ``bit_depth`` bits."""
    rng = np.random.default_rng(seed)
    W = width + step * n
    out = []
    for c, (h, w) in enumerate([(height, W), (height // 2, W // 2), (height // 2, W // 2)]):
        low = rng.random((max(h // 16, 2) + 1, max(w // 16, 2) + 1))
        ys = np.linspace(0, low.shape[0] - 1, h)
        xs = np.linspace(0, low.shape[1] - 1, w)
        y0, x0 = np.floor(ys).astype(int).clip(0, low.shape[0] - 2), \
            np.floor(xs).astype(int).clip(0, low.shape[1] - 2)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        f = (low[y0][:, x0] * (1 - fy) * (1 - fx) + low[y0 + 1][:, x0] * fy * (1 - fx)
             + low[y0][:, x0 + 1] * (1 - fy) * fx + low[y0 + 1][:, x0 + 1] * fy * fx)
        lo_v, hi_v = (30, 220) if c == 0 else (70, 190)
        field = ((lo_v + (hi_v - lo_v) * f) * (1 << (bit_depth - 8))).round().astype(np.int64)
        s = step if c == 0 else step // 2
        wc = width if c == 0 else width // 2
        out.append(np.stack([field[:, i * s:i * s + wc] for i in range(n)]))
    return out


_MF = np.array([[13107, 5243, 8066], [11916, 4660, 7490], [10082, 4194, 6554],
                [9362, 3647, 5825], [8192, 3355, 5243], [7282, 2893, 4559]])
_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]])


def _quant4(res: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """Forward 4x4 transform and quantisation of (..., 4, 4) residuals:
    levels in raster order (..., 16)."""
    w = _CF @ res @ _CF.T
    mf = _MF[qp % 6][_CLASS4].reshape(4, 4)
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    lv = (np.abs(w) * mf + f) >> qbits
    return (np.sign(w) * lv).reshape(*res.shape[:-2], 16)


_BASIS8 = {}


def _quant8(res: np.ndarray, qp: int) -> np.ndarray:
    """Levels (raster, 64) of an 8x8 inter residual: each the residual's
    projection on what the decoder makes of that level alone (measured
    through deq8 and idct8), with a dead zone; any levels serve, since the
    encoder reconstructs as the decoder does."""
    if qp not in _BASIS8:
        unit = np.eye(64, dtype=np.int64) * 64
        _BASIS8[qp] = np.stack([idct8(deq8(u, qp).reshape(8, 8)).reshape(64) for u in unit]) / 64
    basis = _BASIS8[qp]
    x = basis @ res.reshape(64) / np.maximum((basis * basis).sum(1), 1e-9)
    return (np.sign(x) * np.floor(np.abs(x) + 1 / 6)).astype(np.int64)


class _Encoder:
    """Intra 16x16 (the best of its four modes) and P 16x16 at a fixed
    vector (its residual through the 8x8 transform when the stream's PPS
    allows it), with the residual coded, the reconstruction kept without
    deblocking (the stream turns the filter off)."""

    def __init__(self, o: dict, qp: int):
        self.o, self.qp = o, qp
        self.rec = None  # (Y, U, V) of the last picture
        self.ref = None

    def _pred16(self, Y, mx, my, mode):
        x, y = 16 * mx, 16 * my
        top, left = Y[y - 1, x:x + 16], Y[y:y + 16, x - 1]
        if mode == 0:
            return np.tile(top, (16, 1))
        if mode == 1:
            return np.tile(left[:, None], (1, 16))
        if mode == 2:
            if mx and my:
                v = (top.sum() + left.sum() + 16) >> 5
            elif my:
                v = (top.sum() + 8) >> 4
            elif mx:
                v = (left.sum() + 8) >> 4
            else:
                v = 128
            return np.full((16, 16), v)
        k = np.arange(1, 9)
        h = int((k * (Y[y - 1, x + 7 + k] - Y[y - 1, x + 7 - k])).sum())
        v = int((k * (Y[y + 7 + k, x - 1] - Y[y + 7 - k, x - 1])).sum())
        a = 16 * (int(Y[y + 15, x - 1]) + int(Y[y - 1, x + 15]))
        bb, cc = (5 * h + 32) >> 6, (5 * v + 32) >> 6
        yy, xx = np.mgrid[0:16, 0:16]
        return np.clip((a + bb * (xx - 7) + cc * (yy - 7) + 16) >> 5, 0, 255)

    def _pred_chroma_dc(self, C, mx, my):
        x, y = 8 * mx, 8 * my
        out = np.zeros((8, 8), int)
        for by in range(2):
            for bx in range(2):
                st = int(C[y - 1, x + 4 * bx:x + 4 * bx + 4].sum()) if my else None
                sl = int(C[y + 4 * by:y + 4 * by + 4, x - 1].sum()) if mx else None
                first = (bx, by) in ((0, 0), (1, 1))
                if first and st is not None and sl is not None:
                    v = (st + sl + 4) >> 3
                elif (first or bx == 1) and st is not None:
                    v = (st + 2) >> 2
                elif sl is not None:
                    v = (sl + 2) >> 2
                elif st is not None:
                    v = (st + 2) >> 2
                else:
                    v = 128
                out[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = v
        return out

    def _code_chroma(self, C, pred, src, qpc, intra):
        """Levels (dc, ac) of an 8x8 chroma block and its reconstruction."""
        blocks = (src - pred).reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4)
        w = _CF @ blocks @ _CF.T
        dc = w[:, 0, 0].reshape(2, 2)
        hd = np.array([[1, 1], [1, -1]]) @ dc @ np.array([[1, 1], [1, -1]])
        qbits = 15 + qpc // 6
        f = (1 << qbits) // (3 if intra else 6)
        dcl = (np.sign(hd) * ((np.abs(hd) * _MF[qpc % 6][0] + 2 * f) >> (qbits + 1))).reshape(4)
        ac = _quant4(blocks, qpc, intra)
        ac[:, 0] = 0
        dcs = chroma_dc(dcl, qpc)
        rec = np.empty((4, 4, 4), int)
        for k in range(4):
            d = deq4(ac[k], qpc).reshape(4, 4)
            d[0, 0] = dcs[k]
            rec[k] = np.clip(pred.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4)[k]
                             + idct4(d), 0, 255)
        zz = tables().zigzag4
        return ([int(v) for v in dcl], [[int(ac[k][zz[i]]) for i in range(1, 16)] for k in range(4)],
                rec.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8))

    def mb_intra(self, src, mx, my) -> dict:
        Y, U, V = self.rec
        qp = self.qp
        x, y = 16 * mx, 16 * my
        s = src[0][y:y + 16, x:x + 16]
        modes = valid_16_modes(my > 0, mx > 0, mx > 0 and my > 0)
        preds = {m: self._pred16(Y, mx, my, m) for m in modes}
        mode = min(modes, key=lambda m: int(np.abs(s - preds[m]).sum()))
        pred = preds[mode]
        blocks = (s - pred).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)  # (by, bx, 4, 4)
        w = _CF @ blocks @ _CF.T
        dc = w[:, :, 0, 0]
        hd = (_H4 @ dc @ _H4) // 2
        qbits = 15 + qp // 6
        f = (1 << qbits) // 3
        dcl = np.sign(hd) * ((np.abs(hd) * _MF[qp % 6][0] + 2 * f) >> (qbits + 1))
        ac = _quant4(blocks, qp, True)
        ac[..., 0] = 0
        dcs = luma_dc(dcl.reshape(16), qp).reshape(4, 4)
        rec = np.empty((4, 4, 4, 4), int)
        for by in range(4):
            for bx in range(4):
                d = deq4(ac[by, bx], qp).reshape(4, 4)
                d[0, 0] = dcs[by, bx]
                rec[by, bx] = np.clip(pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] + idct4(d), 0, 255)
        zz = tables().zigzag4
        cbp_l = 15 if ac.any() else 0
        Y[y:y + 16, x:x + 16] = rec.transpose(0, 2, 1, 3).reshape(16, 16)
        dcw = [int(dcl.reshape(16)[zz[k]]) for k in range(16)]
        acw = [[int(ac[_zy(blk), _zx(blk)][zz[i]]) for i in range(1, 16)] for blk in range(16)]
        d = dict(kind="I16", mode=mode, cmode=0, dqp=0, dc=dcw, ac=acw)
        cd = []
        for c, P in ((0, U), (1, V)):
            qpc = chroma_qp(qp, self.o["cqp"][c])
            pred_c = self._pred_chroma_dc(P, mx, my)
            cdc, cac, rc = self._code_chroma(P, pred_c, src[c + 1][8 * my:8 * my + 8,
                                                                   8 * mx:8 * mx + 8], qpc, True)
            P[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = rc
            cd.append((cdc, cac))
        d["cdc"] = [cd[0][0], cd[1][0]]
        d["cac"] = [cd[0][1], cd[1][1]]
        cbp_c = 2 if any(any(r) for c in d["cac"] for r in c) else 1 if any(
            any(c) for c in d["cdc"]) else 0
        d["cbp"] = (cbp_c << 4) | cbp_l
        return d

    @staticmethod
    def shifted(planes, mx, my, mv) -> list:
        """The 16x16 luma and 8x8 chroma blocks of macroblock (mx, my)
        moved by integer vector ``mv`` (quarter samples, multiples of 8), the
        picture's edge extended."""
        out = []
        for c, P in enumerate(planes):
            n, f = (16, 4) if c == 0 else (8, 8)
            H, W = P.shape
            ys = np.clip(np.arange(n * my, n * my + n) + mv[1] // f, 0, H - 1)
            xs = np.clip(np.arange(n * mx, n * mx + n) + mv[0] // f, 0, W - 1)
            out.append(P[ys][:, xs].astype(np.int64))
        return out

    def mb_inter(self, src, mx, my, mv, preds=None) -> dict:
        """P_L0_16x16 of integer vector ``mv`` (quarter samples, multiples
        of 8) with the residual coded; ``preds`` (luma, Cb, Cr) another
        prediction to code the residual against."""
        Y, U, V = self.rec
        qp = self.qp
        x, y = 16 * mx, 16 * my
        preds = preds or self.shifted(self.ref, mx, my, mv)
        pred = preds[0]
        s = src[0][y:y + 16, x:x + 16]
        if self.o["t8"]:
            zz8, luma8, cbp = tables().zigzag8, [], 0
            for b8 in range(4):
                y8, x8 = 8 * (b8 >> 1), 8 * (b8 & 1)
                p8 = pred[y8:y8 + 8, x8:x8 + 8]
                lv = _quant8(s[y8:y8 + 8, x8:x8 + 8] - p8, qp)
                Y[y + y8:y + y8 + 8, x + x8:x + x8 + 8] = np.clip(
                    p8 + idct8(deq8(lv, qp).reshape(8, 8)), 0, 255)
                luma8.append([int(lv[zz8[k]]) for k in range(64)])
                cbp |= int(lv.any()) << b8
            d = dict(kind="P", mb_type=0, refs=[0], t8=bool(cbp), dqp=0, luma8=luma8)
        else:
            blocks = (s - pred).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
            lv = _quant4(blocks, qp, False)
            rec = np.empty((4, 4, 4, 4), int)
            for by in range(4):
                for bx in range(4):
                    rec[by, bx] = np.clip(pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
                                          + idct4(deq4(lv[by, bx], qp).reshape(4, 4)), 0, 255)
            Y[y:y + 16, x:x + 16] = rec.transpose(0, 2, 1, 3).reshape(16, 16)
            zz = tables().zigzag4
            luma = [[int(lv[_zy(blk), _zx(blk)][zz[i]]) for i in range(16)] for blk in range(16)]
            cbp = 0
            for b8 in range(4):
                if any(any(luma[4 * b8 + i]) for i in range(4)):
                    cbp |= 1 << b8
            d = dict(kind="P", mb_type=0, refs=[0], t8=False, dqp=0, luma=luma)
        cd = []
        for c, P in enumerate((U, V)):
            qpc = chroma_qp(qp, self.o["cqp"][c])
            pred_c = preds[c + 1]
            cdc, cac, rc = self._code_chroma(P, pred_c, src[c + 1][8 * my:8 * my + 8,
                                                                   8 * mx:8 * mx + 8], qpc, False)
            P[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = rc
            cd.append((cdc, cac))
        d["cdc"] = [cd[0][0], cd[1][0]]
        d["cac"] = [cd[0][1], cd[1][1]]
        cbp_c = 2 if any(any(r) for c in d["cac"] for r in c) else 1 if any(
            any(c) for c in d["cdc"]) else 0
        d["cbp"] = (cbp_c << 4) | cbp
        return d


def _implicit_w0(poc0: int, poc1: int, poc: int) -> int:
    """The implicit weight of list 0 (the decoder's implicit_w0)."""
    td = min(max(poc1 - poc0, -128), 127)
    if not td:
        return 32
    tb = min(max(poc - poc0, -128), 127)
    tx = (16384 + abs(td) // 2) // td if td > 0 else -((16384 + abs(td) // 2) // -td)
    dsf = (tb * tx + 32) >> 8
    return 64 - dsf if -64 <= dsf <= 128 else 32


def smooth_stream(width: int, height: int, n: int, seed: int, step: int = 4, qp: int = 30,
                  gop: int = 0, **kw) -> tuple:
    """(samples, options): a seeded smooth field panning ``step`` pixels a
    frame (``smooth_yuv``), coded as an IDR picture of Intra 16x16
    macroblocks (each the best of its four modes), then P pictures of
    P_L0_16x16 macroblocks at the pan's vector, the residual coded at a
    fixed QP and the deblocking filter off, so that the encoder's
    reconstruction is the decoder's; an IDR picture every ``gop`` (0: only
    the first).  ``t8``: the P pictures' residual through the 8x8
    transform; ``cabac``: CABAC.  With ``bframes``, B pictures between the
    anchors (``pyramid``: the middle one a reference), each macroblock
    B_Bi_16x16 from the nearest picture on either side at the pan's
    vectors (weighted implicitly with ``bipred_idc`` 2); ``p_weight``
    (denominator, weight, offset) weights the P pictures' luma explicitly.
    The samples are then in decoding order, ``options["display"]`` each
    one's display index."""
    bframes, pyramid, p_weight = kw.pop("bframes", 0), kw.pop("pyramid", False), \
        kw.pop("p_weight", None)
    o = options(width, height, **{**dict(t8=False, init_qp=qp, qp_range=(qp, qp), override=False,
                                         max_ref=1, dbk_idc=(1,), pcm=False), **kw})
    if bframes:
        o.update(max_ref=max(o["max_ref"], 3), b_nref=[1, 1], direct="spatial")
    if p_weight:
        o.update(weighted=True, fixed_weights=p_weight)
    src = smooth_yuv(16 * o["mbw"], 16 * o["mbh"], n, seed, step)
    w = StreamWriter(o, seed)
    enc = _Encoder(o, qp)
    if bframes:
        return _smooth_b(o, src, w, enc, n, step, bframes, pyramid, p_weight)
    mv = (4 * step, 0)
    samples = []
    for k in range(n):
        frame = [p[k] for p in src]
        enc.rec = [np.zeros_like(p) for p in frame]

        def body(sink, pic, first, end, stype, slice_qp, num_ref, frame=frame):
            for addr in range(first, end):
                mx, my = addr % pic.mbw, addr // pic.mbw
                if stype == "I":
                    d = enc.mb_intra(frame, mx, my)
                else:  # every predictor is the pan's vector but the first's
                    d = enc.mb_inter(frame, mx, my, mv)
                    d["mvd"] = [mv if addr == 0 else (0, 0)]
                sink.mb(pic, mx, my, d, stype, num_ref)
        units = w.parameter_sets() if k == 0 else []
        samples.append(units + w.picture(k == 0 or bool(gop and k % gop == 0), body))
        enc.ref = enc.rec
    return samples, o


def _smooth_b(o, src, w, enc, n, step, bframes, pyramid, p_weight) -> tuple:
    """``smooth_stream``'s pictures with B pictures, in decoding order."""
    recs = {}  # display index -> the encoder's (Y, U, V) reconstruction
    order = schedule(n, n, bframes, pyramid)
    disp_of = lambda fn: w.ref_info[fn]["poc"] // 2  # noqa: E731
    samples = []
    for k, (disp, kind, ref_idc) in enumerate(order):
        frame = [p[disp] for p in src]
        enc.rec = [np.zeros_like(p) for p in frame]

        def mv_to(ref):  # the pan's vector from this picture to display index `ref`
            return (4 * step * (disp - ref), 0)

        def body(sink, pic, first, end, stype, slice_qp, num_ref, frame=frame, disp=disp):
            refs = [disp_of(lst[0]) for lst in w.lists]
            for addr in range(first, end):
                mx, my = addr % pic.mbw, addr // pic.mbw
                if stype == "I":
                    d = enc.mb_intra(frame, mx, my)
                elif stype == "P":
                    preds = enc.shifted(recs[refs[0]], mx, my, mv_to(refs[0]))
                    if p_weight:
                        den, wt, off = p_weight
                        preds[0] = np.clip((preds[0] * wt + off * (1 << den)
                                            + (1 << den >> 1)) >> den, 0, 255)
                    d = enc.mb_inter(frame, mx, my, None, preds)
                    d["mvd"] = [mv_to(refs[0]) if addr == 0 else (0, 0)]
                else:  # B_Bi_16x16, implicit weights from the POCs
                    p0 = enc.shifted(recs[refs[0]], mx, my, mv_to(refs[0]))
                    p1 = enc.shifted(recs[refs[1]], mx, my, mv_to(refs[1]))
                    w0 = _implicit_w0(2 * refs[0], 2 * refs[1], 2 * disp) \
                        if o["bipred_idc"] == 2 and refs[0] + refs[1] != 2 * disp else 32
                    preds = [(a * w0 + b * (64 - w0) + 32) >> 6 for a, b in zip(p0, p1)]
                    d = enc.mb_inter(frame, mx, my, None, preds)
                    d.update(kind="B", mb_type=3, refs=[[0], [0]],
                             mvd=[[mv_to(refs[0]) if addr == 0 else (0, 0)],
                                  [mv_to(refs[1]) if addr == 0 else (0, 0)]])
                sink.mb(pic, mx, my, d, stype, num_ref)
        units = w.parameter_sets() if k == 0 else []
        samples.append(units + w.picture(kind == "I", body, kind=kind, poc=2 * disp,
                                         ref_idc=ref_idc))
        recs[disp] = enc.rec
    o["display"] = [d for d, _, _ in order]
    return samples, o


# --- containers ---------------------------------------------------------------------


def matrix_fixed(m) -> bytes:
    """A display matrix (a, b, c, d) in ISO BMFF's 16.16 / 2.30 fixed point."""
    a, b_, c, d = m
    F = 1 << 16
    return struct.pack(">9i", round(a * F), round(b_ * F), 0, round(c * F), round(d * F), 0, 0,
                       0, 1 << 30)


def set_matrix(data: bytes, m, box: bytes = b"tkhd") -> bytes:
    """An ISO BMFF file with the first ``box`` (tkhd or mvhd) given the
    display matrix ``m``."""
    out = bytearray(data)
    at = bytes(out).index(box) + 4  # the full box's version
    if box == b"tkhd":
        at += 52 if out[at] == 1 else 40
    else:
        at += 48 if out[at] == 1 else 36
    out[at:at + 36] = matrix_fixed(m)
    return bytes(out)


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + body)


IDENTITY = (1, 0, 0, 1)


def write_mp4(path, samples, width: int, height: int, fps: int = 30, *, sync=None,
              matrix=IDENTITY, fourcc: bytes = b"avc1", length_size: int = 4,
              config_in_band: bool = False, brand: bytes = b"isom", tkhd_version: int = 0,
              movie_matrix=IDENTITY, display=None, ctts_version: int = 0,
              edits="ffmpeg", codec=None) -> None:
    """An ISO BMFF file (``brand`` b"qt  " for .mov) of one H.264 track:
    ``samples`` lists of NAL units, stored behind ``length_size``-byte
    lengths; the parameter sets of the first sample go into ``avcC`` (and
    stay in band with ``config_in_band``); ``sync`` the sync samples (the
    IDR pictures by default); ``matrix`` (a, b, c, d) the track's display
    matrix, ``movie_matrix`` the movie's.  ``display`` gives each sample's
    display index (B pictures): the composition offsets then go into a
    ``ctts`` box, of version 0 shifted to be non-negative with the one edit
    FFmpeg's muxer writes (its media time the first sample's offset), or of
    version 1 unshifted (negative offsets); ``edits`` overrides the edit
    list: None for none, or (segment duration, media time) pairs in movie
    and track ticks.  ``codec`` (another codec's writer, as
    ``torch_hevc_files`` passes it) gives ``is_ps(unit)``, ``is_sync(units)``
    and ``config(parameter sets, length_size)``, the decoder configuration
    box, in place of H.264's; a ``length_size`` of 0 stores each sample's
    one unit as it is (a Motion-JPEG picture)."""
    is_ps = codec.is_ps if codec else (lambda u: u[0] & 31 in (7, 8))
    first = samples[0]
    ps = [u for u in first if is_ps(u)]
    data = []
    for k, s in enumerate(samples):
        units = s if config_in_band or k else [u for u in s if not is_ps(u)]
        data.append(length_prefixed(units, length_size) if length_size else b"".join(units))
    if sync is None:
        is_sync = codec.is_sync if codec else (lambda s: any(u[0] & 31 == 5 for u in s))
        sync = [k for k, s in enumerate(samples) if is_sync(s)]
    if codec:
        config = codec.config(ps, length_size)
    else:
        sps_units = [u for u in ps if u[0] & 31 == 7]
        pps_units = [u for u in ps if u[0] & 31 == 8]
        sp = sps_units[0]
        avcc = bytes([1, sp[1], sp[2], sp[3], 0xFC | (length_size - 1), 0xE0 | len(sps_units)])
        for u in sps_units:
            avcc += struct.pack(">H", len(u)) + u
        avcc += bytes([len(pps_units)])
        for u in pps_units:
            avcc += struct.pack(">H", len(u)) + u
        config = _box(b"avcC", avcc)
    entry = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 + struct.pack(">HH", width, height)
             + struct.pack(">II", 0x480000, 0x480000) + b"\0" * 4 + struct.pack(">H", 1)
             + b"\0" * 32 + struct.pack(">Hh", 24, -1) + config)
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + _box(fourcc, entry))
    n = len(samples)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stss = _full(b"stss", 0, 0, struct.pack(">I", len(sync)) + b"".join(
        struct.pack(">I", k + 1) for k in sync))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n) + b"".join(
        struct.pack(">I", len(d)) for d in data))
    ftyp = _box(b"ftyp", brand + struct.pack(">I", 0x200) + brand + (b"hvc1" if codec else b"avc1"))
    mdat_start = len(ftyp) + 8
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, mdat_start))
    ctts = b""
    delay = 0
    if display is not None and list(display) != list(range(n)):
        offs = [int(d) - k for k, d in enumerate(display)]
        if ctts_version == 0:
            delay = -min(offs)
            offs = [v + delay for v in offs]
        ctts = _full(b"ctts", ctts_version, 0, struct.pack(">I", n) + b"".join(
            struct.pack(">Ii" if ctts_version else ">II", 1, v) for v in offs))
    stbl = _box(b"stbl", stsd + stts + ctts + stss + stsc + stsz + stco)
    vmhd = _full(b"vmhd", 0, 1, b"\0" * 8)
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b"")))
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"vide" + b"\0" * 12 + b"VideoHandler\0")
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    mat = matrix_fixed
    duration = n * 1000 // fps
    if tkhd_version == 1:
        times = struct.pack(">QQIIQ", 0, 0, 1, 0, duration)
    else:
        times = struct.pack(">IIIII", 0, 0, 1, 0, duration)
    tkhd = _full(b"tkhd", tkhd_version, 3, times + b"\0" * 8 + struct.pack(">hhhH", 0, 0, 0, 0)
                 + mat(matrix) + struct.pack(">II", width << 16, height << 16))
    if edits == "ffmpeg":
        edits = [(duration, delay)] if ctts else None
    edts = b""
    if edits is not None:
        edts = _box(b"edts", _full(b"elst", 0, 0, struct.pack(">I", len(edits)) + b"".join(
            struct.pack(">IiI", dur, t, 0x10000) for dur, t in edits)))
    trak = _box(b"trak", tkhd + edts + mdia)
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, duration)
                 + struct.pack(">IH", 0x10000, 0x100) + b"\0" * 10 + mat(movie_matrix)
                 + b"\0" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)
    mdat = _box(b"mdat", b"".join(data))
    pathlib.Path(path).write_bytes(ftyp + mdat + moov)


def write_avi_h264(path, samples, width: int, height: int, fps: int = 30,
                   fourcc: bytes = b"H264") -> None:
    """A RIFF AVI of Annex B samples (``torch_video_files.write_avi``), its
    IDR samples the key frames."""
    from torch_video_files import write_avi

    write_avi(path, [annexb(s) for s in samples], width, height, fps, fourcc,
              keys=[k for k, s in enumerate(samples) if any(u[0] & 31 == 5 for u in s)])

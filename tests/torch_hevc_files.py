"""HEVC video files for the port's video tests and fixtures, written here
(cv2's libavcodec decodes HEVC but holds no encoder for it): Main profile
streams of I and P pictures, or with ``bframes`` of I, P and B pictures
in decoding order as x265 orders them (``b_schedule``: anchors, B
pyramids, IRAP pictures with RASL or RADL leading pictures, BLA pictures),
whose syntax is drawn at random from what the port's decoder takes
(``random_stream``), or coded from a smooth picture that pans
(``smooth_stream``), behind NAL unit lengths in ``.mp4``/``.mov``
(``write_mp4``: ``hvc1`` with the parameter sets in ``hvcC``, or ``hev1``
with them in band too; ``display=`` gives B pictures FFmpeg's ``ctts``
and edit) or Annex B in ``.avi`` (``write_avi``).  Needs no cv2.

The arithmetic coder is ``torch_h264_files.CabacEncoder`` (the engine H.264
and HEVC share) over HEVC's contexts (``HevcCabac``), their initial values
read from the decoder's source (``csrc/host/hevc.cpp``): a wrong entry
there gives a stream cv2 reads otherwise, so cv2's decode is the check.
``SliceWriter`` binarises each syntax element and chooses its context as
clause 9.3.4.2 (and the decoder) chooses them.

``random_stream`` draws per CTU the SAO parameters (merges, band and edge
offsets), the coding quadtree (CTBs cut by the picture's edges), per CU
``cu_skip_flag``, intra or inter, every partition the SPS allows (AMP,
NxN at the smallest CU), intra modes through the MPMs or
``rem_intra_luma_pred_mode``, all chroma modes, merge indices, reference
indices over up to 4 references, MVDs (vectors far outside the picture
too) and both MVP flags; the transform tree (splits, ``cbf_*``,
``cu_qp_delta``) and residual levels of every magnitude with
``transform_skip``; per picture the slice splits, ``slice_qp_delta``,
chroma QP offsets, the deblocking controls, SAO flags, list modification,
``collocated_ref_idx`` and explicit weights; in B slices
``inter_pred_idc`` (no bi-prediction for 8x4 and 4x8 blocks), both lists'
references, MVDs and MVP flags, ``mvd_l1_zero_flag``,
``collocated_from_l0_flag`` and both lists' weights; per stream WPP, sign data
hiding, constrained intra prediction, strong intra smoothing, TMVP, the
parallel merge level, ``cu_qp_delta`` depth, the RPS in the SPS (with
inter-RPS prediction) or in the slice header, the VUI and the
conformance window.  Levels are bounded to 16 bits, as the standard
bounds them.

Imported by ``tests/test_torch_hevc.py``, ``tests/test_torch_hevc_b.py``
and ``scripts/make_hevc_fixtures.py``.
"""

from __future__ import annotations

import pathlib
import re
import struct

import numpy as np

import torch_h264_files as hf
from torch_h264_files import Bits

_HOST_SRC = pathlib.Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch" / "csrc" \
    / "host" / "hevc.cpp"

# the decoder's context offsets (enum Ctx in hevc.cpp)
SAO_MERGE, SAO_TYPE, SPLIT_CU, TQ_BYPASS, CU_SKIP, CU_QP_DELTA, PRED_MODE, PART_MODE = \
    0, 1, 2, 5, 6, 9, 11, 12
PREV_INTRA, CHROMA_MODE, MERGE_FLAG, MERGE_IDX, INTER_PRED, REF_IDX, MVD_GT0, MVD_GT1 = \
    16, 17, 18, 19, 20, 25, 27, 28
MVP_FLAG, RQT_ROOT_CBF, SPLIT_TRANSFORM, CBF_LUMA, CBF_CHROMA, TRANSFORM_SKIP = \
    29, 30, 31, 34, 36, 40
LAST_X, LAST_Y, CODED_SUB_BLOCK, SIG_COEFF, GT1, GT2, NUM_CTX = 42, 60, 78, 82, 124, 148, 154

CTX_IDX_MAP = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]
PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N = \
    range(8)
IDR_W_RADL, IDR_N_LP, CRA, TRAIL_R, TRAIL_N = 19, 20, 21, 1, 0
RADL_N, RADL_R, RASL_N, RASL_R, BLA_W_LP, BLA_W_RADL, BLA_N_LP = 6, 7, 8, 9, 16, 17, 18
PRED_L0, PRED_L1, PRED_BI = 1, 2, 3  # inter_pred_idc as prediction flags (bit 0 list 0, bit 1 list 1)
VPS, SPS, PPS, AUD, EOS, SEI = 32, 33, 34, 35, 36, 39


class _Tables:
    def __init__(self):
        src = _HOST_SRC.read_text()
        body = re.search(r"CTX_INIT\[3\]\[NUM_CTX\] = \{(.*?)\};", src, re.S).group(1)
        vals = [int(v) for v in re.findall(r"\d+", body)]
        assert len(vals) == 3 * NUM_CTX, len(vals)
        self.ctx_init = [vals[NUM_CTX * k:NUM_CTX * (k + 1)] for k in range(3)]
        self.scan = {}
        for lg in range(4):
            s = 1 << lg
            diag, x, y = [], 0, 0
            while len(diag) < s * s:
                while y >= 0:
                    if x < s and y < s:
                        diag.append((x, y))
                    y -= 1
                    x += 1
                y, x = x, 0
            horiz = [(i % s, i // s) for i in range(s * s)]
            vert = [(i // s, i % s) for i in range(s * s)]
            self.scan[lg] = [diag, horiz, vert]


_TABLES = None


def tables() -> _Tables:
    global _TABLES
    if _TABLES is None:
        _TABLES = _Tables()
    return _TABLES


# --- NAL units and parameter sets (7.3.1-7.3.2) --------------------------------------


def nal(kind: int, rbsp: bytes, tid: int = 0, layer: int = 0) -> bytes:
    """A NAL unit: its two-byte header and the RBSP with emulation prevention."""
    return bytes([(kind << 1) | (layer >> 5), ((layer & 31) << 3) | (tid + 1)]) + _escape(rbsp)[0]


def _escape(data: bytes, marks=()) -> tuple:
    """``data`` with emulation_prevention_three_bytes, and the output position
    of each input position in ``marks`` (an inserted byte before a mark
    counts before it)."""
    out, zeros, pos = bytearray(), 0, {}
    marks = set(marks)
    for i, c in enumerate(data):
        if zeros >= 2 and c <= 3:
            out.append(3)
            zeros = 0
        if i in marks:
            pos[i] = len(out)
        out.append(c)
        zeros = zeros + 1 if c == 0 else 0
    for m in marks:
        pos.setdefault(m, len(out))
    return bytes(out), pos


def kind_of(unit: bytes) -> int:
    return (unit[0] >> 1) & 63


def profile_of(o: dict) -> int:
    """general_profile_idc: 1 (Main) at 8 bits, else 2 (Main 10)."""
    return 1 if max(o.get("bit_depth", 8), o.get("bit_depth_chroma", 8)) == 8 else 2


def profile_tier_level(b: Bits, max_sub_layers_minus1: int = 0, level: int = 93,
                       profile: int = 1) -> None:
    b.u(profile, 8)  # general_profile_space 0, tier 0, profile_idc
    # general_profile_compatibility_flag[1] and [2] (Main), [2] (Main 10)
    b.u(0x60000000 if profile == 1 else 0x20000000, 32)
    b.u(0x9, 4)  # progressive_source, interlaced, non_packed_constraint, frame_only_constraint
    b.u(0, 32)
    b.u(0, 12)
    b.u(level, 8)
    for _ in range(max_sub_layers_minus1):
        b.flag(0)
        b.flag(0)
    if max_sub_layers_minus1:
        for _ in range(max_sub_layers_minus1, 8):
            b.u(0, 2)


def vps(o: dict) -> bytes:
    b = Bits()
    b.u(0, 4)
    b.flag(1)
    b.flag(1)
    b.u(0, 6)
    b.u(o["sub_layers"] - 1, 3)
    b.flag(1)
    b.u(0xFFFF, 16)
    profile_tier_level(b, o["sub_layers"] - 1, profile=profile_of(o))
    b.flag(0)
    b.ue(o["dpb"] - 1)
    b.ue(o["reorder"])
    b.ue(o["latency"])
    b.u(0, 6)  # vps_max_layer_id
    b.ue(0)  # vps_num_layer_sets_minus1
    b.flag(0)  # vps_timing_info_present_flag
    b.flag(0)
    return nal(VPS, b.rbsp())


def st_ref_pic_set(b: Bits, r: dict, idx: int, num: int, sets: list) -> None:
    """st_ref_pic_set(idx): ``r`` is {"neg": [(delta, used)...], "pos": [...]}
    coded explicitly, or {"inter": (delta_idx, delta_rps, used, use_delta)}."""
    if idx:
        b.flag("inter" in r)
    if "inter" in r:
        delta_idx, delta_rps, used, use_delta = r["inter"]
        if idx == num:
            b.ue(delta_idx - 1)
        b.flag(delta_rps < 0)
        b.ue(abs(delta_rps) - 1)
        for u, d in zip(used, use_delta):
            b.flag(u)
            if not u:
                b.flag(d)
        return
    b.ue(len(r["neg"]))
    b.ue(len(r["pos"]))
    prev = 0
    for d, u in r["neg"]:
        b.ue(prev - d - 1)
        prev = d
        b.flag(u)
    prev = 0
    for d, u in r["pos"]:
        b.ue(d - prev - 1)
        prev = d
        b.flag(u)


def derive_rps(r: dict, sets: list) -> dict:
    """The (delta, used) lists of an inter-predicted set (7.4.8) from the set
    it predicts from (``sets``: those before it in order), as the decoder
    derives them."""
    if "inter" not in r:
        return r
    delta_idx, delta_rps, used, use_delta = r["inter"]
    ref = derive_rps(sets[len(sets) - delta_idx], sets[:len(sets) - delta_idx])
    neg, pos = ref["neg"], ref["pos"]
    n = len(neg) + len(pos)
    out_neg, out_pos = [], []
    for j in range(len(pos) - 1, -1, -1):
        d = pos[j][0] + delta_rps
        if d < 0 and use_delta[len(neg) + j]:
            out_neg.append((d, used[len(neg) + j]))
    if delta_rps < 0 and use_delta[n]:
        out_neg.append((delta_rps, used[n]))
    for j in range(len(neg)):
        d = neg[j][0] + delta_rps
        if d < 0 and use_delta[j]:
            out_neg.append((d, used[j]))
    for j in range(len(neg) - 1, -1, -1):
        d = neg[j][0] + delta_rps
        if d > 0 and use_delta[j]:
            out_pos.append((d, used[j]))
    if delta_rps > 0 and use_delta[n]:
        out_pos.append((delta_rps, used[n]))
    for j in range(len(pos)):
        d = pos[j][0] + delta_rps
        if d > 0 and use_delta[len(neg) + j]:
            out_pos.append((d, used[len(neg) + j]))
    return {"neg": out_neg, "pos": out_pos}


def sps(o: dict) -> bytes:
    b = Bits()
    b.u(0, 4)
    b.u(o["sub_layers"] - 1, 3)
    b.flag(1)
    profile_tier_level(b, o["sub_layers"] - 1, profile=profile_of(o))
    b.ue(o.get("sps_id", 0))
    b.ue(o.get("chroma_format", 1))
    if o.get("chroma_format", 1) == 3:
        b.flag(0)
    b.ue(o["width"])
    b.ue(o["height"])
    crop = o["crop"]  # left, right, top, bottom in luma samples
    b.flag(any(crop))
    if any(crop):
        for v in crop:
            b.ue(v // 2)
    b.ue(o.get("bit_depth", 8) - 8)
    b.ue(o.get("bit_depth_chroma", o.get("bit_depth", 8)) - 8)
    b.ue(o["log2_max_poc_lsb"] - 4)
    b.flag(1)  # sps_sub_layer_ordering_info_present_flag
    for _ in range(o["sub_layers"]):
        b.ue(o["dpb"] - 1)
        b.ue(o["reorder"])
        b.ue(o["latency"])
    b.ue(o["log2_min_cb"] - 3)
    b.ue(o["log2_ctb"] - o["log2_min_cb"])
    b.ue(o["log2_min_tb"] - 2)
    b.ue(o["log2_max_tb"] - o["log2_min_tb"])
    b.ue(o["depth_inter"])
    b.ue(o["depth_intra"])
    b.flag(o.get("scaling", False))
    if o.get("scaling", False):
        b.flag(0)  # sps_scaling_list_data_present_flag: the default lists
    b.flag(o["amp"])
    b.flag(o["sao"])
    b.flag(o.get("pcm", False))
    if o.get("pcm", False):
        b.u(7, 4)
        b.u(7, 4)
        b.ue(0)
        b.ue(0)
        b.flag(0)
    sets = o["rps_sets"]
    b.ue(len(sets))
    for i, r in enumerate(sets):
        st_ref_pic_set(b, r, i, len(sets), sets)
    b.flag(o.get("long_term", False))
    if o.get("long_term", False):
        b.ue(0)
    b.flag(o["tmvp"])
    b.flag(o["strong"])
    vui = o.get("vui")
    b.flag(vui is not None)
    if vui is not None:
        b.flag(0)  # aspect_ratio_info
        b.flag(0)  # overscan
        signal = "full_range" in vui or "matrix" in vui
        b.flag(signal)
        if signal:
            b.u(5, 3)
            b.flag(vui.get("full_range", False))
            colour = "matrix" in vui
            b.flag(colour)
            if colour:
                b.u(vui.get("prim", 2), 8)
                b.u(vui.get("trc", 2), 8)
                b.u(vui["matrix"], 8)
        loc = vui.get("chroma_loc")  # chroma_sample_loc_type_top_field, _bottom_field
        b.flag(loc is not None)
        if loc is not None:
            b.ue(loc[0])
            b.ue(loc[1])
        b.flag(0)  # neutral_chroma_indication_flag
        b.flag(0)  # field_seq_flag
        b.flag(0)  # frame_field_info_present_flag
        b.flag(0)  # default_display_window_flag
        timing = vui.get("timing", False)
        b.flag(timing)
        if timing:
            b.u(1001, 32)
            b.u(30000, 32)
            b.flag(0)
            b.flag(0)
        restriction = vui.get("restriction", False)
        b.flag(restriction)
        if restriction:
            b.flag(0)
            b.flag(1)
            b.flag(1)
            b.ue(0)
            b.ue(2)
            b.ue(1)
            b.ue(15)
            b.ue(15)
    ext = o.get("sps_extension", 0)
    b.flag(bool(ext))
    if ext:
        b.u(ext, 8)
        b.flag(0)
        b.flag(0)
        b.flag(0)
        b.flag(0)
        b.flag(0)
        b.flag(0)
        b.flag(0)
        b.flag(0)
        b.flag(0)
    return nal(SPS, b.rbsp())


def pps(o: dict, p: dict) -> bytes:
    b = Bits()
    b.ue(p["id"])
    b.ue(o.get("sps_id", 0))
    b.flag(p.get("dependent", False))
    b.flag(p["output_flag"])
    b.u(p["extra_bits"], 3)
    b.flag(p["sdh"])
    b.flag(p["cabac_init_present"])
    b.ue(p["num_ref_default"] - 1)
    b.ue(p.get("num_ref_default1", 1) - 1)
    b.se(p["init_qp"] - 26)
    b.flag(p["cip"])
    b.flag(p["ts"])
    b.flag(p["cu_qp_delta"])
    if p["cu_qp_delta"]:
        b.ue(p["qg_depth"])
    b.se(p["cqp"][0])
    b.se(p["cqp"][1])
    b.flag(p["slice_cqp"])
    b.flag(p["weighted"])
    b.flag(p.get("weighted_bipred", False))
    b.flag(p.get("bypass", False))
    b.flag(p.get("tiles", False))
    if p.get("tiles", False):
        b.ue(1)
        b.ue(0)
        b.flag(1)
        b.flag(1)
    b.flag(p["wpp"])
    b.flag(p["lf_across"])
    ctrl = p["dbk_ctrl"]
    b.flag(ctrl is not None)
    if ctrl is not None:
        override, disabled, beta, tc = ctrl
        b.flag(override)
        b.flag(disabled)
        if not disabled:
            b.se(beta)
            b.se(tc)
    b.flag(0)  # pps_scaling_list_data_present_flag
    b.flag(p["lists_mod"])
    b.ue(p["par_mrg"] - 2)
    b.flag(p["header_ext"])
    ext = p.get("pps_extension", 0)
    b.flag(bool(ext))
    if ext:
        b.u(ext, 8)
        b.flag(0)
        b.flag(0)
        b.ue(0)
        b.ue(0)
        b.ue(0)
    return nal(PPS, b.rbsp())


def _sps_depths(unit: bytes) -> tuple:
    """(general_profile_idc, BitDepthY, BitDepthC) of an SPS NAL unit
    (single-layer, as ``sps`` writes it)."""
    raw = bytes(unit[2:]).replace(b"\x00\x00\x03", b"\x00\x00")
    bits = "".join(f"{v:08b}" for v in raw)
    assert not (raw[0] >> 1) & 7, "sub-layers in the SPS"
    at = 8 + 96  # after the first byte and profile_tier_level's general part

    def ue():
        nonlocal at
        z = bits.index("1", at) - at
        v = int(bits[at + z:at + 2 * z + 1], 2) - 1
        at += 2 * z + 1
        return v
    ue()  # sps_seq_parameter_set_id
    chroma = ue()
    at += chroma == 3
    ue()
    ue()
    if bits[at] == "1":
        at += 1
        for _ in range(4):
            ue()
    else:
        at += 1
    return raw[1] & 31, ue() + 8, ue() + 8


def hvcc(ps: list, length_size: int = 4) -> bytes:
    """The ``hvcC`` box (ISO/IEC 14496-15 8.3.3.1) of the parameter sets
    ``ps``, its profile and bit depths those of the first SPS."""
    sps_units = [u for u in ps if kind_of(u) == SPS]
    profile, depth_y, depth_c = _sps_depths(sps_units[0]) if sps_units else (1, 8, 8)
    compat = 0x60000000 if profile == 1 else 0x20000000
    body = bytes([1, profile]) + compat.to_bytes(4, "big") + bytes([0x90, 0, 0, 0, 0, 0, 93])
    body += bytes([0xF0, 0x00, 0xFC, 0xFD, 0xF8 | (depth_y - 8), 0xF8 | (depth_c - 8), 0, 0,
                   0x0C | (length_size - 1)])
    arrays = [(k, [u for u in ps if kind_of(u) == k]) for k in (VPS, SPS, PPS)]
    arrays = [(k, us) for k, us in arrays if us]
    body += bytes([len(arrays)])
    for k, us in arrays:
        body += bytes([0x80 | k]) + len(us).to_bytes(2, "big")
        for u in us:
            body += len(u).to_bytes(2, "big") + u
    return hf._box(b"hvcC", body)


class _Mp4Codec:
    @staticmethod
    def is_ps(u: bytes) -> bool:
        return kind_of(u) in (VPS, SPS, PPS)

    @staticmethod
    def is_sync(units) -> bool:
        return any(16 <= kind_of(u) <= 23 for u in units)

    @staticmethod
    def config(ps, length_size: int) -> bytes:
        return hvcc(ps, length_size)


class _ColrCodec(_Mp4Codec):
    """``_Mp4Codec`` with a ``colr`` box of type ``nclx`` after ``hvcC``."""

    def __init__(self, colr):
        self.colr = colr

    def config(self, ps, length_size: int) -> bytes:
        prim, trc, matrix, full = self.colr
        return hvcc(ps, length_size) + hf._box(b"colr", b"nclx" + struct.pack(
            ">HHHB", prim, trc, matrix, 0x80 if full else 0))


def write_mp4(path, samples, width: int, height: int, fps: int = 30, colr=None, **kw) -> None:
    """An ISO BMFF file of one HEVC track (``torch_h264_files.write_mp4``'s
    options): ``fourcc`` b"hvc1" (the parameter sets of the first sample in
    ``hvcC`` only) or b"hev1" with ``config_in_band`` (kept in band too);
    ``display`` (``options["display"]`` of a B stream) each sample's display
    index, for FFmpeg's ``ctts`` and edit; ``colr`` (primaries, transfer,
    matrix, full range) a ``colr`` box of type ``nclx`` in the sample entry,
    as phones write one beside the VUI."""
    kw.setdefault("fourcc", b"hvc1")
    hf.write_mp4(path, samples, width, height, fps,
                 codec=_Mp4Codec if colr is None else _ColrCodec(colr), **kw)


def write_avi(path, samples, width: int, height: int, fps: int = 30,
              fourcc: bytes = b"HEVC") -> None:
    """A RIFF AVI of Annex B samples, its IRAP samples the key frames."""
    from torch_video_files import write_avi as avi

    avi(path, [hf.annexb(s) for s in samples], width, height, fps, fourcc,
        keys=[k for k, s in enumerate(samples) if _Mp4Codec.is_sync(s)])


# --- CABAC (clause 9.3) --------------------------------------------------------------


class HevcCabac(hf.CabacEncoder):
    """``CabacEncoder`` over HEVC's contexts, initialised as 9.3.2.2 does for
    ``init_type`` (0 I, 1 P, 2 P with cabac_init_flag) at slice QP ``qp``."""

    def __init__(self, init_type: int, qp: int):  # not CabacEncoder's: that reads H.264's contexts
        q = min(max(qp, 0), 51)
        self.p, self.mps = [], []
        for v in tables().ctx_init[init_type]:
            m, n = (v >> 4) * 5 - 45, ((v & 15) << 3) - 16
            pre = min(max(((m * q) >> 4) + n, 1), 126)
            self.p.append(63 - pre if pre <= 63 else pre - 64)
            self.mps.append(int(pre > 63))
        h = hf.tables()
        self.lps, self.trans = h.range_lps, h.trans_lps
        self.out = []
        self.start()

    def states(self) -> tuple:
        return list(self.p), list(self.mps)

    def load(self, st: tuple) -> None:
        self.p, self.mps = list(st[0]), list(st[1])


def qp_offset(o: dict) -> int:
    """QpBdOffset of the stream's bit depth."""
    return 6 * (o.get("bit_depth", 8) - 8)


def sao_offset_max(o: dict) -> int:
    """sao_offset_abs's cMax: 7 at 8 bits, 15 at 9, 31 at 10."""
    return (1 << (min(o.get("bit_depth", 8), 10) - 5)) - 1


def _zscan_in_ctb(x4: int, y4: int) -> int:
    z = 0
    for i in range(4):
        z |= (((x4 >> i) & 1) << (2 * i)) | (((y4 >> i) & 1) << (2 * i + 1))
    return z


class PicState:
    """What the contexts and the intra mode derivation read of the picture
    being written: by 4x4 block the coding tree depth, skip and intra flags,
    the luma mode; by CTB its slice."""

    def __init__(self, o: dict):
        self.W, self.H, self.lc = o["width"], o["height"], o["log2_ctb"]
        self.w4, self.h4 = self.W // 4, self.H // 4
        self.ctb_w = -(-self.W >> self.lc)
        self.ctb_h = -(-self.H >> self.lc)
        self.depth = np.zeros((self.h4, self.w4), np.int64)
        self.skip = np.zeros((self.h4, self.w4), bool)
        self.intra = np.zeros((self.h4, self.w4), bool)
        self.mode = np.ones((self.h4, self.w4), np.int64)
        cm = (1 << (self.lc - 2)) - 1
        self.zs = np.zeros((self.h4, self.w4), np.int64)
        for y in range(self.h4):
            for x in range(self.w4):
                ctb = (y >> (self.lc - 2)) * self.ctb_w + (x >> (self.lc - 2))
                self.zs[y, x] = (ctb << (2 * (self.lc - 2))) + _zscan_in_ctb(x & cm, y & cm)
        self.ctb_slice = -np.ones(self.ctb_w * self.ctb_h, np.int64)

    def ctb_of(self, x: int, y: int) -> int:
        return (y >> self.lc) * self.ctb_w + (x >> self.lc)

    def avail(self, xc, yc, xn, yn) -> bool:
        if xn < 0 or yn < 0 or xn >= self.W or yn >= self.H:
            return False
        if self.zs[yn >> 2, xn >> 2] > self.zs[yc >> 2, xc >> 2]:
            return False
        a = self.ctb_slice[self.ctb_of(xn, yn)]
        return a >= 0 and a == self.ctb_slice[self.ctb_of(xc, yc)]

    def fill(self, arr, x0, y0, w, h, v) -> None:
        arr[y0 >> 2:(y0 + h) >> 2, x0 >> 2:(x0 + w) >> 2] = v


def mpm_candidates(pic: PicState, x: int, y: int) -> list:
    """candModeList of the prediction block at (x, y) (8.4.2)."""
    a = int(pic.mode[y >> 2, (x - 1) >> 2]) if pic.avail(x, y, x - 1, y) and \
        pic.intra[y >> 2, (x - 1) >> 2] else 1
    b = 1
    if pic.avail(x, y, x, y - 1) and pic.intra[(y - 1) >> 2, x >> 2] and \
            ((y - 1) >> pic.lc) == (y >> pic.lc):
        b = int(pic.mode[(y - 1) >> 2, x >> 2])
    if a == b:
        return [0, 1, 26] if a < 2 else [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    return [a, b, 0 if a and b else 1 if a != 1 and b != 1 else 26]


def chroma_mode_of(syntax: int, luma: int) -> int:
    if syntax == 4:
        return luma
    m = [0, 26, 10, 1][syntax]
    return 34 if m == luma else m


def scan_idx_of(intra: bool, log2: int, c: int, mode: int) -> int:
    if intra and (log2 == 2 or (log2 == 3 and c == 0)):
        return 2 if 6 <= mode <= 14 else 1 if 22 <= mode <= 30 else 0
    return 0


def _last_binarise(v: int) -> tuple:
    """(prefix, suffix, suffix bits) of a last significant coefficient coordinate."""
    if v < 4:
        return v, 0, 0
    p = 4
    while True:
        nb = (p >> 1) - 1
        base = (1 << nb) * (2 + (p & 1))
        if base <= v < base + (1 << nb):
            return p, v - base, nb
        p += 1


# --- the syntax of a slice segment's data (7.3.8) ---------------------------------------


def pu_boxes(part: int, x0: int, y0: int, size: int) -> list:
    """(x, y, w, h) of a CU's prediction blocks in coding order."""
    h, q = size // 2, size // 4
    return {PART_2Nx2N: [(x0, y0, size, size)],
            PART_2NxN: [(x0, y0, size, h), (x0, y0 + h, size, h)],
            PART_Nx2N: [(x0, y0, h, size), (x0 + h, y0, h, size)],
            PART_2NxnU: [(x0, y0, size, q), (x0, y0 + q, size, size - q)],
            PART_2NxnD: [(x0, y0, size, size - q), (x0, y0 + size - q, size, q)],
            PART_nLx2N: [(x0, y0, q, size), (x0 + q, y0, size - q, size)],
            PART_nRx2N: [(x0, y0, size - q, size), (x0 + size - q, y0, q, size)],
            PART_NxN: [(x0, y0, h, h), (x0 + h, y0, h, h), (x0, y0 + h, h, h),
                       (x0 + h, y0 + h, h, h)]}[part]



class SliceWriter:
    """One slice segment's CTUs into substreams (one a CTB row under WPP):
    each syntax element that ``chooser`` decides, binarised, its context
    chosen as the decoder chooses it."""

    def __init__(self, o: dict, p: dict, pic: PicState, sl: dict, idx: int, chooser):
        self.o, self.p, self.pic, self.sl, self.idx, self.ch = o, p, pic, sl, idx, chooser
        init_type = 0 if sl["type"] == "I" else 2 if (sl["type"] == "P") == sl["cabac_init"] else 1
        self.init = (init_type, sl["qp"])
        self.e = HevcCabac(*self.init)
        self.min_qg = o["log2_ctb"] - (p["qg_depth"] if p["cu_qp_delta"] else 0)
        self.substreams = []
        self.b = Bits()

    def dec(self, ctx: int, v) -> None:
        self.e.decision(ctx, int(bool(v)))

    def byp(self, v) -> None:
        self.e.bypass(int(bool(v)))

    def bits(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.byp((v >> k) & 1)

    def _flush_substream(self) -> None:
        self.e.drain(self.b)
        self.b.align_zero()
        s = "".join(self.b.parts)
        self.substreams.append(int(s, 2).to_bytes(len(s) // 8, "big") if s else b"")
        self.b = Bits()

    def run(self, first: int, end: int) -> list:
        """CTBs ``first`` to ``end`` - 1 (raster addresses): the substreams."""
        pic, o = self.pic, self.o
        wpp = self.p["wpp"]
        saved = None
        for a in range(first, end):
            rx, ry = a % pic.ctb_w, a // pic.ctb_w
            pic.ctb_slice[a] = self.idx
            if wpp and rx == 0:
                self.qg_first = True
            if a == first:
                self.qg_first = True
            self.addr = a
            if self.sl["sao_luma"] or self.sl["sao_chroma"]:
                self.sao(rx, ry, first)
            self.quadtree(rx << o["log2_ctb"], ry << o["log2_ctb"], o["log2_ctb"], 0)
            last = a == end - 1
            self.e.terminate(int(last))  # end_of_slice_segment_flag
            if wpp and rx == 1:
                saved = (self.e.states(), ry)
            if last:
                self._flush_substream()
                break
            if wpp and (a + 1) % pic.ctb_w == 0:
                self.e.terminate(1)  # end_of_subset_one_bit
                self._flush_substream()
                self.e.start()
                if pic.ctb_w > 1 and saved is not None and saved[1] == ry:
                    self.e.load(saved[0])
                else:
                    self.e.load(HevcCabac(*self.init).states())
        return self.substreams

    # -- sao (7.3.8.3) ----------------------------------------------------------------

    def sao(self, rx, ry, first) -> None:
        pic, sl = self.pic, self.sl
        a = self.addr
        choice = self.ch.sao(a, rx > 0 and a - 1 >= first, ry > 0 and a - pic.ctb_w >= first)
        if rx > 0 and a - 1 >= first:
            self.dec(SAO_MERGE, choice == "left")
            if choice == "left":
                return
        if ry > 0 and a - pic.ctb_w >= first:
            self.dec(SAO_MERGE, choice == "up")
            if choice == "up":
                return
        for c in range(3):
            if not (sl["sao_chroma"] if c else sl["sao_luma"]):
                continue
            kind, offs, band, eo = choice[c]
            if c < 2:
                self.dec(SAO_TYPE, kind != 0)
                if kind:
                    self.byp(kind == 2)
            if not kind:
                continue
            cmax = sao_offset_max(self.o)
            for v in offs:
                for k in range(min(abs(v), cmax)):
                    self.byp(1)
                if abs(v) < cmax:
                    self.byp(0)
            if kind == 1:
                for v in offs:
                    if v:
                        self.byp(v < 0)
                self.bits(band, 5)
            elif c < 2:
                self.bits(eo, 2)

    # -- coding quadtree and unit (7.3.8.4-7.3.8.5) -------------------------------------

    def quadtree(self, x0, y0, log2, depth) -> None:
        pic, o = self.pic, self.o
        size = 1 << log2
        if x0 + size <= pic.W and y0 + size <= pic.H and log2 > o["log2_min_cb"]:
            split = self.ch.split(x0, y0, log2, depth)
            c = int(pic.avail(x0, y0, x0 - 1, y0) and pic.depth[y0 >> 2, (x0 - 1) >> 2] > depth) + \
                int(pic.avail(x0, y0, x0, y0 - 1) and pic.depth[(y0 - 1) >> 2, x0 >> 2] > depth)
            self.dec(SPLIT_CU + c, split)
        else:
            split = log2 > o["log2_min_cb"]
        if log2 == self.min_qg or (log2 > self.min_qg and not split):
            self.qp_coded = False
        if split:
            h = size >> 1
            self.quadtree(x0, y0, log2 - 1, depth + 1)
            if x0 + h < pic.W:
                self.quadtree(x0 + h, y0, log2 - 1, depth + 1)
            if y0 + h < pic.H:
                self.quadtree(x0, y0 + h, log2 - 1, depth + 1)
            if x0 + h < pic.W and y0 + h < pic.H:
                self.quadtree(x0 + h, y0 + h, log2 - 1, depth + 1)
        else:
            self.cu(x0, y0, log2, depth)

    def cu(self, x0, y0, log2, depth) -> None:
        pic, o, sl = self.pic, self.o, self.sl
        size = 1 << log2
        d = self.ch.cu(x0, y0, log2, depth, self)
        pic.fill(pic.depth, x0, y0, size, size, depth)
        pic.fill(pic.skip, x0, y0, size, size, False)
        pic.fill(pic.intra, x0, y0, size, size, False)
        pic.fill(pic.mode, x0, y0, size, size, 1)
        if sl["type"] != "I":
            c = int(pic.avail(x0, y0, x0 - 1, y0) and pic.skip[y0 >> 2, (x0 - 1) >> 2]) + \
                int(pic.avail(x0, y0, x0, y0 - 1) and pic.skip[(y0 - 1) >> 2, x0 >> 2])
            self.dec(CU_SKIP + c, d["skip"])
        self.intra, self.part = d.get("intra", False), d.get("part", PART_2Nx2N)
        self.depth = depth
        if d["skip"]:
            pic.fill(pic.skip, x0, y0, size, size, True)
            self.pu(d["pus"][0], sl["max_merge"], skipped=True, box=(x0, y0, size, size))
            return
        if sl["type"] != "I":
            self.dec(PRED_MODE, self.intra)
        if not self.intra or log2 == o["log2_min_cb"]:
            self.part_mode(log2, self.part)
        pic.fill(pic.intra, x0, y0, size, size, self.intra)
        if self.intra:
            self.intra_modes(x0, y0, log2, d["modes"], d["chroma"])
        else:
            for pu, box in zip(d["pus"], pu_boxes(self.part, x0, y0, size)):
                self.pu(pu, sl["max_merge"], box=box)
        root = True
        if not self.intra and not (self.part == PART_2Nx2N and d["pus"][0]["merge"]):
            root = d["root_cbf"]
            self.dec(RQT_ROOT_CBF, root)
        if root:
            md = o["depth_intra"] + (self.part == PART_NxN) if self.intra else o["depth_inter"]
            self.tree(x0, y0, x0, y0, log2, 0, 0, md, False, False)

    def part_mode(self, log2, part) -> None:
        o = self.o
        self.dec(PART_MODE, part == PART_2Nx2N)
        if part == PART_2Nx2N:
            return
        if log2 == o["log2_min_cb"]:
            if self.intra:
                return
            self.dec(PART_MODE + 1, part == PART_2NxN)
            if part == PART_2NxN or log2 == 3:
                return
            self.dec(PART_MODE + 2, part == PART_Nx2N)
            return
        horizontal = part in (PART_2NxN, PART_2NxnU, PART_2NxnD)
        self.dec(PART_MODE + 1, horizontal)
        if not o["amp"]:
            return
        self.dec(PART_MODE + 3, part in (PART_2NxN, PART_Nx2N))
        if part in (PART_2NxnU, PART_2NxnD):
            self.byp(part == PART_2NxnD)
        elif part in (PART_nLx2N, PART_nRx2N):
            self.byp(part == PART_nRx2N)

    def intra_modes(self, x0, y0, log2, modes, chroma) -> None:
        pic = self.pic
        n = 4 if self.part == PART_NxN else 1
        pb = (1 << log2) // 2 if n == 4 else 1 << log2
        plans = []
        for i in range(n):
            x, y = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
            cand = mpm_candidates(pic, x, y)
            m = modes[i]
            plans.append((cand.index(m),) if m in cand else (None, sorted(cand), m))
            pic.fill(pic.mode, x, y, pb, pb, m)
            pic.fill(pic.intra, x, y, pb, pb, True)
        for pl in plans:
            self.dec(PREV_INTRA, pl[0] is not None)
        for pl in plans:
            if pl[0] is not None:
                idx = pl[0]
                self.byp(idx > 0)
                if idx > 0:
                    self.byp(idx > 1)
            else:
                _, cand, m = pl
                rem = m - sum(1 for c in cand if c < m)
                self.bits(rem, 5)
        self.dec(CHROMA_MODE, chroma != 4)
        if chroma != 4:
            self.bits(chroma, 2)
        self.luma0 = modes[0]
        self.chroma = chroma_mode_of(chroma, modes[0])

    def pu(self, d: dict, max_merge: int, skipped: bool = False, box=None) -> None:
        """prediction_unit of the block ``box`` (x, y, w, h): merged, or per
        list used (``dir``, B slices) its ``ref``/``mvd``/``mvp`` (list 0)
        and ``ref1``/``mvd1``/``mvp1`` (list 1)."""
        if not skipped:
            self.dec(MERGE_FLAG, d["merge"])
        if d["merge"]:
            if max_merge > 1:
                idx = d["idx"]
                self.dec(MERGE_IDX, idx > 0)
                if idx > 0:
                    for k in range(1, max_merge - 1):
                        self.byp(idx > k)
                        if idx == k:
                            break
            return
        sl = self.sl
        direction = d.get("dir", PRED_L0)
        if sl["type"] == "B":  # inter_pred_idc
            if box[2] + box[3] == 12:
                assert direction != PRED_BI, "a bi-predicted 8x4 or 4x8 block"
            else:
                self.dec(INTER_PRED + self.depth, direction == PRED_BI)
            if direction != PRED_BI:
                self.dec(INTER_PRED + 4, direction == PRED_L1)
        for lst in (0, 1):
            if not (direction >> lst) & 1:
                continue
            sfx = "1" if lst else ""
            self._ref_idx(d["ref" + sfx], sl["num_ref1" if lst else "num_ref"])
            if not (lst and direction == PRED_BI and sl.get("mvd_l1_zero")):
                self._mvd(d["mvd" + sfx])
            self.dec(MVP_FLAG, d["mvp" + sfx])

    def _ref_idx(self, r: int, nref: int) -> None:
        if nref > 1:
            for k in range(nref - 1):
                if k < 2:
                    self.dec(REF_IDX + k, r > k)
                else:
                    self.byp(r > k)
                if r == k:
                    break

    def _mvd(self, mvd) -> None:
        dx, dy = mvd
        self.dec(MVD_GT0, dx != 0)
        self.dec(MVD_GT0, dy != 0)
        if dx:
            self.dec(MVD_GT1, abs(dx) > 1)
        if dy:
            self.dec(MVD_GT1, abs(dy) > 1)
        for v in (dx, dy):
            if v:
                if abs(v) > 1:
                    self.e.exp_golomb(abs(v) - 2, 1)
                self.byp(v < 0)

    # -- transform tree and unit (7.3.8.8-7.3.8.12) -------------------------------------

    def tree(self, x0, y0, xb, yb, log2, depth, blk, max_depth, pcb, pcr) -> None:
        o = self.o
        intra_split = self.intra and self.part == PART_NxN
        if o["log2_max_tb"] >= log2 > o["log2_min_tb"] and depth < max_depth and \
                not (intra_split and depth == 0):
            split = self.ch.tsplit(x0, y0, log2, depth)
            self.dec(SPLIT_TRANSFORM + 5 - log2, split)
        else:
            inter_split = o["depth_inter"] == 0 and not self.intra and self.part != PART_2Nx2N \
                and depth == 0
            split = log2 > o["log2_max_tb"] or (intra_split and depth == 0) or inter_split
        cb, cr = pcb, pcr
        if log2 > 2:
            cb = cr = False
            if depth == 0 or pcb:
                cb = self.ch.cbf(x0, y0, log2, depth, 1, split)
                self.dec(CBF_CHROMA + depth, cb)
            if depth == 0 or pcr:
                cr = self.ch.cbf(x0, y0, log2, depth, 2, split)
                self.dec(CBF_CHROMA + depth, cr)
        if split:
            h = 1 << (log2 - 1)
            for k, (x, y) in enumerate([(x0, y0), (x0 + h, y0), (x0, y0 + h), (x0 + h, y0 + h)]):
                self.tree(x, y, x0, y0, log2 - 1, depth + 1, k, max_depth, cb, cr)
            return
        luma = True
        if self.intra or depth or cb or cr:
            luma = self.ch.cbf(x0, y0, log2, depth, 0, False)
            self.dec(CBF_LUMA + (1 if depth == 0 else 0), luma)
        if (luma or cb or cr) and self.p["cu_qp_delta"] and not self.qp_coded:
            v = self.ch.qp_delta()
            a = abs(v)
            for k in range(min(a, 5)):
                self.dec(CU_QP_DELTA + (k > 0), 1)
            if a < 5:
                self.dec(CU_QP_DELTA + (a > 0), 0)
            else:
                self.e.exp_golomb(a - 5, 0)
            if a:
                self.byp(v < 0)
            self.qp_coded = True
        pic = self.pic
        if luma:
            mode = int(pic.mode[y0 >> 2, x0 >> 2])
            self.residual(self.ch.levels(x0, y0, log2, 0), log2, 0,
                          scan_idx_of(self.intra, log2, 0, mode))
        if log2 > 2 or blk == 3:
            xc, yc, lc = (x0 // 2, y0 // 2, log2 - 1) if log2 > 2 else (xb // 2, yb // 2, 2)
            for c, f in ((1, cb), (2, cr)):
                if f:
                    self.residual(self.ch.levels(xc, yc, lc, c), lc, c,
                                  scan_idx_of(self.intra, lc, c, self.chroma if self.intra else 0))

    def residual(self, lv, log2: int, c: int, scan_idx: int) -> None:
        """residual_coding of the (n, n) levels ``lv`` (``lv[y, x]``; a tuple
        (levels, transform_skip_flag) when the PPS allows it); the sign the
        decoder infers where a sign is hidden is written back into ``lv``."""
        ts = False
        if isinstance(lv, tuple):
            lv, ts = lv
        if self.p["ts"] and log2 == 2:
            self.dec(TRANSFORM_SKIP + (1 if c else 0), ts)
        t = tables()
        lsb = log2 - 2
        sb_scan, pos_scan = t.scan[lsb][scan_idx], t.scan[2][scan_idx]
        order = [(xs * 4 + px, ys * 4 + py) for xs, ys in sb_scan for px, py in pos_scan]
        last = max(i for i, (x, y) in enumerate(order) if lv[y, x])
        lx, ly = order[last]
        if scan_idx == 2:
            lx, ly = ly, lx
        off, shift = (15, log2 - 2) if c else (3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2)
        mx = (log2 << 1) - 1
        parts = []
        for base, v in ((LAST_X, lx), (LAST_Y, ly)):
            p, s, nb = _last_binarise(v)
            for i in range(min(p + 1, mx)):
                self.dec(base + off + (i >> shift), i < p)
            parts.append((s, nb))
        for s, nb in parts:
            self.bits(s, nb)
        last_sb, last_pos = last // 16, last % 16
        nsb = 1 << lsb
        csbf = np.zeros((nsb, nsb), bool)
        g1ctx = 1
        for i in range(last_sb, -1, -1):
            xs, ys = sb_scan[i]
            vals = [int(lv[ys * 4 + py, xs * 4 + px]) for px, py in pos_scan]
            infer = False
            if 0 < i < last_sb:
                coded = any(vals)
                right = csbf[xs + 1, ys] if xs < nsb - 1 else 0
                below = csbf[xs, ys + 1] if ys < nsb - 1 else 0
                self.dec(CODED_SUB_BLOCK + (2 if c else 0) + min(int(right) + int(below), 1), coded)
                infer = True
            else:
                coded = True
            csbf[xs, ys] = coded
            prev = (int(csbf[xs + 1, ys]) if xs < nsb - 1 else 0) | \
                ((int(csbf[xs, ys + 1]) if ys < nsb - 1 else 0) << 1)
            sig = [last_pos] if i == last_sb else []
            if coded:
                for k in range(last_pos - 1 if i == last_sb else 15, -1, -1):
                    if k > 0 or not infer:
                        xc, yc = xs * 4 + pos_scan[k][0], ys * 4 + pos_scan[k][1]
                        if log2 == 2:
                            sc = CTX_IDX_MAP[(yc << 2) + xc]
                        elif xc + yc == 0:
                            sc = 0
                        else:
                            xp, yp = xc & 3, yc & 3
                            if prev == 0:
                                sc = 2 if xp + yp == 0 else 1 if xp + yp < 3 else 0
                            elif prev == 1:
                                sc = 2 if yp == 0 else 1 if yp == 1 else 0
                            elif prev == 2:
                                sc = 2 if xp == 0 else 1 if xp == 1 else 0
                            else:
                                sc = 2
                            if c == 0:
                                sc += (3 if i > 0 else 0) + ((9 if scan_idx == 0 else 15) if log2 == 3
                                                             else 21)
                            else:
                                sc += 9 if log2 == 3 else 12
                        self.dec(SIG_COEFF + (27 if c else 0) + sc, vals[k] != 0)
                        if vals[k]:
                            sig.append(k)
                            infer = False
                    else:
                        assert vals[0], "an inferred DC that is zero"
                        sig.append(0)
            if not sig:
                continue
            ctx_set = 2 if (i > 0 and c == 0) else 0
            if i != last_sb and g1ctx == 0:
                ctx_set += 1
            g1ctx = 1
            mags = [abs(vals[k]) for k in sig]
            first_g1 = -1
            for m in range(min(len(sig), 8)):
                g = mags[m] > 1
                self.dec(GT1 + (16 if c else 0) + (ctx_set << 2) + g1ctx, g)
                if g:
                    g1ctx = 0
                    if first_g1 < 0:
                        first_g1 = m
                elif 0 < g1ctx < 3:
                    g1ctx += 1
            if first_g1 >= 0:
                self.dec(GT2 + (4 if c else 0) + ctx_set, mags[first_g1] > 2)
            hidden = self.p["sdh"] and sig[0] - sig[-1] > 3
            for m, k in enumerate(sig):
                if not (hidden and m == len(sig) - 1):
                    self.byp(vals[k] < 0)
            rice = 0
            for m, k in enumerate(sig):
                base = 1 if m >= 8 else 1 + (mags[m] > 1) + (m == first_g1 and mags[m] > 2)
                if base == (1 if m >= 8 else 3 if m == first_g1 else 2):
                    self._remaining(mags[m] - base, rice)
                    if mags[m] > 3 * (1 << rice):
                        rice = min(rice + 1, 4)
            if hidden:  # the decoder's sign of the lowest coefficient
                k = sig[-1]
                neg = sum(mags) % 2 == 1
                lv[ys * 4 + pos_scan[k][1], xs * 4 + pos_scan[k][0]] = -mags[-1] if neg else mags[-1]

    def _remaining(self, v: int, rice: int) -> None:
        if v < (4 << rice):
            for _ in range(v >> rice):
                self.byp(1)
            self.byp(0)
            self.bits(v & ((1 << rice) - 1), rice)
            return
        p = 4
        while v >= (((1 << (p + 1 - 3)) + 2) << rice):
            p += 1
        for _ in range(p):
            self.byp(1)
        self.byp(0)
        self.bits(v - (((1 << (p - 3)) + 2) << rice), p - 3 + rice)


# --- random syntax ---------------------------------------------------------------------


def _levels(rng, n: int, big: float = 0.1) -> np.ndarray:
    """(n, n) levels, at least one not zero: sparse, mostly small, a few of
    every magnitude up to 16 bits."""
    lv = np.zeros((n, n), np.int64)
    k = int(rng.integers(1, max(2, n * n // int(rng.choice([1, 2, 4, 8])) + 1)))
    k = min(k, n * n)
    cells = rng.choice(n * n, size=k, replace=False)
    # low frequencies more often
    if n > 4 and rng.random() < 0.6:
        cells = cells % (n * min(n, 8))
    for c in cells:
        r = rng.random()
        mag = 1 if r < 0.5 else int(rng.integers(2, 6)) if r < 0.8 else \
            int(rng.integers(6, 200)) if r < 1 - big else int(rng.integers(200, 32768))
        lv[c // n, c % n] = mag if rng.random() < 0.5 else -mag
    if not lv.any():
        lv[0, 0] = 1
    return lv


class RandomChooser:
    """Every decision of a slice's syntax drawn at random within what the
    stream's parameter sets allow."""

    def __init__(self, rng, o: dict, p: dict, sl: dict):
        self.rng, self.o, self.p, self.sl = rng, o, p, sl

    def sao(self, a, can_left, can_up):
        rng = self.rng
        r = rng.random()
        if can_left and r < 0.2:
            return "left"
        if can_up and r < 0.35:
            return "up"
        out = []
        for c in range(3):
            kind = int(rng.choice(self.o.get("sao_kinds", [0, 1, 2]))) if c < 2 else out[1][0]
            offs = [int(rng.integers(0, sao_offset_max(self.o) + 1)) * (1 if rng.random() < 0.5 else -1)
                    for _ in range(4)]
            eo = int(rng.choice(self.o.get("eo_classes", [0, 1, 2, 3]))) if c < 2 else out[1][3]
            out.append((kind, offs, int(rng.integers(0, 32)), eo))
        return out

    def split(self, x0, y0, log2, depth) -> bool:
        return self.rng.random() < (0.75 if log2 >= 5 else 0.45)

    def cu(self, x0, y0, log2, depth, w) -> dict:
        rng, o, sl = self.rng, self.o, self.sl
        size = 1 << log2
        p_slice = sl["type"] != "I"
        d = {"skip": p_slice and rng.random() < o.get("p_skip", 0.15)}
        if d["skip"]:
            d["pus"] = [{"merge": True, "idx": int(rng.integers(0, sl["max_merge"]))}]
            return d
        d["intra"] = not p_slice or rng.random() < o.get("p_intra", 0.25)
        if d["intra"]:
            d["part"] = PART_NxN if log2 == o["log2_min_cb"] and log2 > o["log2_min_tb"] and \
                rng.random() < 0.4 else PART_2Nx2N
            d["modes"] = [int(rng.integers(0, 35)) for _ in range(4 if d["part"] == PART_NxN else 1)]
            d["chroma"] = int(rng.integers(0, 5))
            return d
        parts = [PART_2Nx2N, PART_2NxN, PART_Nx2N]
        if log2 == o["log2_min_cb"] and log2 > 3:
            parts.append(PART_NxN)
        if o["amp"] and log2 > o["log2_min_cb"]:
            parts += [PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N]
        d["part"] = int(rng.choice(o.get("parts", parts)))
        npu = {PART_2Nx2N: 1, PART_NxN: 4}.get(d["part"], 2)
        d["pus"] = []
        boxes = pu_boxes(d["part"], x0, y0, size)
        for k in range(npu):
            if rng.random() < o.get("p_merge", 0.45):
                d["pus"].append({"merge": True, "idx": int(rng.integers(0, sl["max_merge"]))})
                continue
            if sl["type"] == "B":
                d["pus"].append(self._b_pu(boxes[k]))
                continue
            big = self.o.get("mvd", 16)
            mvd = [int(rng.integers(-big, big + 1)) if rng.random() < 0.7 else 0 for _ in range(2)]
            if self.o.get("far_mv") and rng.random() < 0.1:
                mvd = [int(rng.integers(-4000, 4000)) for _ in range(2)]
            d["pus"].append({"merge": False, "ref": int(rng.integers(0, sl["num_ref"])),
                             "mvd": mvd, "mvp": int(rng.integers(0, 2))})
        d["root_cbf"] = rng.random() < 0.7
        return d

    def _b_pu(self, box) -> dict:
        """A B slice's AMVP block: its lists (``o["dirs"]`` narrows them; no
        bi-prediction for an 8x4 or 4x8 block), each list's reference,
        MVD and MVP flag."""
        rng, o, sl = self.rng, self.o, self.sl
        dirs = [v for v in o.get("dirs", [PRED_L0, PRED_L1, PRED_BI, PRED_BI])
                if v != PRED_BI or box[2] + box[3] != 12] or [PRED_L0]
        pu = {"merge": False, "dir": int(rng.choice(dirs))}
        big = o.get("mvd", 16)
        for lst, sfx in ((0, ""), (1, "1")):
            mvd = [int(rng.integers(-big, big + 1)) if rng.random() < 0.7 else 0 for _ in range(2)]
            if o.get("far_mv") and rng.random() < 0.1:
                mvd = [int(rng.integers(-4000, 4000)) for _ in range(2)]
            pu["ref" + sfx] = int(rng.integers(0, sl["num_ref1" if lst else "num_ref"]))
            pu["mvd" + sfx] = mvd
            pu["mvp" + sfx] = int(rng.integers(0, 2))
        return pu

    def tsplit(self, x0, y0, log2, depth) -> bool:
        return self.rng.random() < 0.4

    def cbf(self, x0, y0, log2, depth, c, split) -> bool:
        if self.sl["type"] != "I" and "p_cbf" in self.o:
            return self.rng.random() < self.o["p_cbf"]
        return self.rng.random() < (0.6 if c == 0 else 0.45)

    def qp_delta(self) -> int:  # CuQpDeltaVal, -(26 + QpBdOffset / 2) to 25 + QpBdOffset / 2
        r, half = self.rng.random(), qp_offset(self.o) // 2
        return 0 if r < 0.3 else int(self.rng.integers(-3, 4)) if r < 0.8 else \
            int(self.rng.integers(-26 - half, 26 + half))

    def levels(self, x0, y0, log2, c):
        lv = _levels(self.rng, 1 << log2, self.o.get("big", 0.1))
        if self.p["ts"] and log2 == 2:
            return lv, bool(self.rng.random() < 0.5)
        return lv


# --- streams ----------------------------------------------------------------------------


def options(width: int, height: int, seed: int = 0, **kw) -> dict:
    """A stream's settings: the coded size rounded up to the smallest CU (the
    rest cropped), and every tool drawn from ``seed`` unless ``kw`` fixes it."""
    rng = np.random.default_rng(10_000 + seed)
    o = dict(log2_ctb=int(rng.choice([4, 4, 5, 6])), log2_min_cb=3, log2_min_tb=2,
             sub_layers=1, log2_max_poc_lsb=int(rng.choice([4, 5, 8])), poc_step=int(rng.choice([1, 2])),
             amp=bool(rng.random() < 0.7), sao=bool(rng.random() < 0.7), tmvp=bool(rng.random() < 0.7),
             strong=bool(rng.random() < 0.5), max_ref=int(rng.integers(1, 5)), reorder=0, latency=0,
             vui=None, crop_extra=(0, 0), nonref=0.2, slices=int(rng.integers(1, 4)),
             intra_in_p=0.15)
    o["depth_inter"] = int(rng.integers(0, 3))
    o["depth_intra"] = int(rng.integers(0, 3))
    o.update({k: v for k, v in kw.items() if k != "pps"})
    o["log2_max_tb"] = kw.get("log2_max_tb", min(o["log2_ctb"], 5))
    mcb = 1 << o["log2_min_cb"]
    o["width"] = -(-width // mcb) * mcb + o["crop_extra"][0]
    o["height"] = -(-height // mcb) * mcb + o["crop_extra"][1]
    o["crop"] = kw.get("crop", [0, o["width"] - width, 0, o["height"] - height])
    o["dpb"] = kw.get("dpb", o["max_ref"] + 1 + o["reorder"])
    p = dict(id=0, output_flag=False, extra_bits=int(rng.integers(0, 3)), sdh=bool(rng.random() < 0.6),
             cabac_init_present=bool(rng.random() < 0.5), num_ref_default=int(rng.integers(1, 4)),
             init_qp=int(rng.integers(22, 38)), cip=bool(rng.random() < 0.3), ts=bool(rng.random() < 0.6),
             cu_qp_delta=bool(rng.random() < 0.6), qg_depth=0, cqp=[int(v) for v in rng.integers(-6, 7, 2)],
             slice_cqp=bool(rng.random() < 0.5), weighted=bool(rng.random() < 0.4),
             wpp=bool(rng.random() < 0.5), lf_across=bool(rng.random() < 0.5),
             dbk_ctrl=None if rng.random() < 0.3 else (bool(rng.random() < 0.6), bool(rng.random() < 0.2),
                                                        int(rng.integers(-6, 7)), int(rng.integers(-6, 7))),
             lists_mod=bool(rng.random() < 0.5), par_mrg=int(rng.integers(2, o["log2_ctb"] + 1)),
             header_ext=bool(rng.random() < 0.2))
    if p["cu_qp_delta"]:
        p["qg_depth"] = int(rng.integers(0, o["log2_ctb"] - o["log2_min_cb"] + 1))
    if qp_offset(o):  # QPs below 0 too, down to -QpBdOffset
        p["init_qp"] = int(rng.integers(-qp_offset(o), 38))
    p.update(kw.get("pps", {}))
    o["pps"] = p
    o["rps_sets"] = kw.get("rps_sets", _sps_sets(o, rng))
    return o


def _sps_sets(o: dict, rng) -> list:
    """The SPS's sets: k references at -step .. -k * step for k = 1..max_ref,
    each after the first predicted from the one before it (inter RPS), and
    one with random used flags coded explicitly."""
    s = o["poc_step"]
    sets = [{"neg": [(-s, 1)], "pos": []}]
    for k in range(2, o["max_ref"] + 1):
        sets.append({"inter": (1, -s, [1] * k, [1] * k)})
    if o["max_ref"] > 1:
        used = [int(v) for v in rng.integers(0, 2, o["max_ref"])]
        used[0] = 1
        sets.append({"neg": [(-s * (i + 1), used[i]) for i in range(o["max_ref"])], "pos": []})
    return sets


class StreamWriter:
    """Parameter sets and pictures of one stream: the RPS and reference lists
    kept as the decoder keeps them, slices and their substreams assembled
    into NAL units with the entry points the data needs."""

    def __init__(self, o: dict, seed: int):
        self.o, self.p = o, o["pps"]
        self.rng = np.random.default_rng(seed)
        self.refs = []  # POCs of the reference pictures held, oldest first
        self.poc = 0
        self.sets = [derive_rps(r, o["rps_sets"][:i]) for i, r in enumerate(o["rps_sets"])]

    def parameter_sets(self) -> list:
        return [vps(self.o), sps(self.o), pps(self.o, self.p)]

    def picture(self, kind: str, chooser_of=None, nal_type=None, output=True,
                no_output_of_prior=False) -> list:
        """One picture's slice NAL units: ``kind`` "IDR", "CRA", "P" or "N" (a
        P picture no later one references); ``chooser_of(sl)`` gives each
        slice's decisions (random syntax by default)."""
        o, p, rng = self.o, self.p, self.rng
        pic = PicState(o)
        irap = kind in ("IDR", "CRA")
        if kind == "IDR":
            self.poc = 0
            self.refs = []
            typ = nal_type if nal_type is not None else int(rng.choice([IDR_W_RADL, IDR_N_LP]))
        else:
            self.poc += o["poc_step"]
            typ = CRA if kind == "CRA" else TRAIL_N if kind == "N" else TRAIL_R
            if kind == "CRA":
                self.refs = []
        deltas = [r - self.poc for r in reversed(self.refs)]
        used = [int(v) for v in rng.integers(0, 2, len(deltas))] if not irap else [0] * len(deltas)
        if deltas and not irap:
            used[int(rng.integers(0, len(used)))] = 1
        if irap:
            deltas, used = [], []
        need = {"neg": list(zip(deltas, used)), "pos": []}
        curr = [self.poc + d for d, u in zip(deltas, used) if u]
        # picture-level slice settings
        pl = dict(kind=kind, typ=typ, poc=self.poc, rps=need, output=output,
                  no_output_of_prior=no_output_of_prior)
        if not irap:
            pl["tmvp"] = o["tmvp"] and rng.random() < 0.8
            nr = int(rng.integers(1, 5)) if rng.random() < 0.6 else p["num_ref_default"]
            nr = o.get("num_ref", nr)
            pl["num_ref"] = nr
            total = len(curr)
            pl["entries"] = None
            if p["lists_mod"] and total > 1 and rng.random() < 0.6:
                pl["entries"] = [int(v) for v in rng.integers(0, total, nr)]
            temp = (curr * (max(nr, total) // max(total, 1) + 1))[:max(nr, total)]
            pl["list"] = [temp[e] for e in pl["entries"]] if pl["entries"] else temp[:nr]
            pl["col"] = int(rng.integers(0, nr))
        units = self._slices(pl, pic, irap, chooser_of)
        if kind != "N":
            self.refs = (self.refs + [self.poc])[-o["max_ref"]:]
        return units

    def _slices(self, pl: dict, pic, irap: bool, chooser_of) -> list:
        """The picture's slices as NAL units, cut where ``_slice_cuts`` cuts."""
        o, p, rng = self.o, self.p, self.rng
        n_ctb = pic.ctb_w * pic.ctb_h
        cuts = self._slice_cuts(pic, n_ctb)
        units = []
        for idx, (first, end) in enumerate(zip(cuts[:-1], cuts[1:])):
            sl = self._slice_params(pl, irap, idx)
            ch = chooser_of(sl) if chooser_of else RandomChooser(rng, o, p, sl)
            sw = SliceWriter(o, p, pic, sl, idx, ch)
            subs = sw.run(first, end)
            units.append(self._slice_nal(pl, sl, first, subs))
        return units

    def coded_picture(self, pic: dict, chooser_of=None, output: bool = True,
                      no_output_of_prior: bool = False) -> list:
        """One picture of a ``b_schedule`` (its NAL type ``typ``, ``poc``, the
        POCs it predicts from, ``used``, and those it keeps for later
        pictures, ``keep``): the RPS and both lists from those, each slice
        I, P or B (``kind`` "B": B slices mostly; "P": P slices, or B slices
        of past references alone by chance ``gpb``)."""
        o, p, rng = self.o, self.p, self.rng
        irap = 16 <= pic["typ"] <= 23
        poc = pic["poc"]
        deltas = sorted({r - poc for r in pic["used"]} | {r - poc for r in pic["keep"]})
        used = {r - poc for r in pic["used"]}
        need = {"neg": [(d, int(d in used)) for d in reversed(deltas) if d < 0],
                "pos": [(d, int(d in used)) for d in deltas if d > 0]}
        before = [poc + d for d, u in need["neg"] if u]
        after = [poc + d for d, u in need["pos"] if u]
        total = len(before) + len(after)
        pl = dict(kind="IRAP" if irap else pic["kind"], typ=pic["typ"], poc=poc, rps=need,
                  output=output, no_output_of_prior=no_output_of_prior)
        if not irap:
            b = pic["kind"] == "B" or rng.random() < o.get("gpb", 0.3)
            pl["b"] = b
            pl["tmvp"] = o["tmvp"] and rng.random() < 0.8
            for lst, sfx, first, second in ((0, "", before, after), (1, "1", after, before)):
                nr = int(rng.integers(1, 5)) if rng.random() < 0.6 else \
                    p["num_ref_default" if not lst else "num_ref_default1"]
                nr = o.get("num_ref", nr)
                pl["num_ref" + sfx] = nr
                pl["entries" + sfx] = None
                if p["lists_mod"] and total > 1 and rng.random() < 0.6:
                    pl["entries" + sfx] = [int(v) for v in rng.integers(0, total, nr)]
                temp = ((first + second) * nr)[:max(nr, total)]
                pl["list" + sfx] = [temp[e] for e in pl["entries" + sfx]] if pl["entries" + sfx] \
                    else temp[:nr]
            pl["col_l0"] = not b or rng.random() < o.get("p_col_l0", 0.5)
            pl["col"] = int(rng.integers(0, pl["num_ref"] if pl["col_l0"] else pl["num_ref1"]))
        return self._slices(pl, PicState(o), irap, chooser_of)

    def _slice_cuts(self, pic, n_ctb) -> list:
        o, rng = self.o, self.rng
        k = min(o["slices"], n_ctb)
        cuts = sorted(set([0, n_ctb] + [int(v) for v in rng.integers(1, n_ctb, k - 1)])) if k > 1 \
            else [0, n_ctb]
        if self.p["wpp"]:  # a slice starting inside a row ends in it
            fixed = [0]
            for c in cuts[1:]:
                start = fixed[-1]
                if start % pic.ctb_w and c // pic.ctb_w != start // pic.ctb_w and \
                        c != (start // pic.ctb_w + 1) * pic.ctb_w:
                    c = (start // pic.ctb_w + 1) * pic.ctb_w
                if c > start:
                    fixed.append(c)
            if fixed[-1] != n_ctb:
                fixed.append(n_ctb)
            cuts = fixed
        return cuts

    def _slice_params(self, pl: dict, irap: bool, idx: int = 0) -> dict:
        o, p, rng = self.o, self.p, self.rng
        sl = dict(type="I" if irap or rng.random() < o["intra_in_p"] else "P")
        if sl["type"] == "P" and pl.get("b"):  # a B picture's slice: B, or by chance P
            # (not where the collocated picture is list 1's: every slice names the same one)
            sl["type"] = "P" if pl["col_l0"] and rng.random() < o.get("p_in_b", 0.15) else "B"
        sl["qp"] = int(rng.integers(max(p["init_qp"] - 12, -qp_offset(o)), min(p["init_qp"] + 12, 51) + 1))
        sl["sao_luma"] = o["sao"] and rng.random() < 0.7
        sl["sao_chroma"] = o["sao"] and rng.random() < 0.7
        sl["cabac_init"] = p["cabac_init_present"] and rng.random() < 0.5
        sl["max_merge"] = int(rng.integers(1, 6))
        sl["num_ref"] = pl.get("num_ref", 0)
        sl["num_ref1"] = pl.get("num_ref1", 0)
        sl["cqp"] = [min(max(int(v), -12 - q), 12 - q) for v, q in zip(rng.integers(-4, 5, 2), p["cqp"])] \
            if p["slice_cqp"] else [0, 0]  # the sum with the PPS's within +-12
        ctrl = p["dbk_ctrl"]
        sl["dbk"] = None
        if ctrl is not None and ctrl[0] and rng.random() < 0.6:
            sl["dbk"] = (bool(rng.random() < 0.3), int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
        if idx == 0:
            pl["first_off"] = sl["dbk"] is not None and sl["dbk"][0]
        elif pl.get("first_off"):  # refused: a later slice enabling the filter again
            sl["dbk"] = (True, 0, 0)
        disabled = ctrl[1] if ctrl is not None else False
        if sl["dbk"] is not None:
            disabled = sl["dbk"][0]
        sl["lf_across"] = bool(rng.random() < 0.5)
        sl["lf_coded"] = p["lf_across"] and (sl["sao_luma"] or sl["sao_chroma"] or not disabled)
        if sl["type"] == "P" and p["weighted"]:
            sl["weights"] = self._weights([sl["num_ref"]])
        if sl["type"] == "B":
            sl["mvd_l1_zero"] = bool(rng.random() < o.get("p_mvd_l1_zero", 0.3))
            if p.get("weighted_bipred"):
                sl["weights"] = self._weights([sl["num_ref"], sl["num_ref1"]])
        sl.update(o.get("slice_over", {}))
        return sl

    def _weights(self, counts: list) -> tuple:
        """pred_weight_table's values for lists of ``counts`` references:
        (luma denominator, chroma denominator, by list the (luma, chroma)
        (weight delta, offset) pairs or None)."""
        rng = self.rng
        ld = int(rng.integers(0, 8))
        cd = int(rng.integers(max(0, ld - 3), min(7, ld + 3) + 1))
        lists = []
        for n in counts:
            w = []
            for _ in range(n):
                lw = (int(rng.integers(-128, 128)), int(rng.integers(-128, 128))) if rng.random() < 0.6 \
                    else None
                cw = [(int(rng.integers(-128, 128)), int(rng.integers(-512, 512))) for _ in range(2)] \
                    if rng.random() < 0.5 else None
                w.append((lw, cw))
            lists.append(w)
        return (ld, cd, *lists)

    def _slice_nal(self, pl: dict, sl: dict, first: int, subs: list) -> bytes:
        o, p = self.o, self.p
        b = Bits()
        irap = 16 <= pl["typ"] <= 23
        b.flag(first == 0)
        if irap:
            b.flag(pl["no_output_of_prior"])
        b.ue(p["id"])
        if first:
            if p.get("dependent"):
                b.flag(0)
            pic_ctbs = (-(-o["width"] >> o["log2_ctb"])) * (-(-o["height"] >> o["log2_ctb"]))
            b.u(first, max(1, (pic_ctbs - 1).bit_length()))
        b.u(0, p["extra_bits"])
        b.ue({"B": 0, "P": 1, "I": 2}[sl["type"]])
        if p["output_flag"]:
            b.flag(pl["output"])
        if pl["typ"] not in (IDR_W_RADL, IDR_N_LP):
            b.u(pl["poc"] & ((1 << o["log2_max_poc_lsb"]) - 1), o["log2_max_poc_lsb"])
            idx = None
            for i, r in enumerate(self.sets):
                if r["neg"] == pl["rps"]["neg"] and r["pos"] == pl["rps"]["pos"]:
                    idx = i
            if idx is not None and self.rng.random() < 0.7:
                b.flag(1)
                if len(self.sets) > 1:
                    b.u(idx, (len(self.sets) - 1).bit_length())
            else:
                b.flag(0)
                st_ref_pic_set(b, pl["rps"], len(self.sets), len(self.sets), self.sets)
            if o["tmvp"]:
                b.flag(pl.get("tmvp", False))
        if o["sao"]:
            b.flag(sl["sao_luma"])
            b.flag(sl["sao_chroma"])
        if sl["type"] in ("P", "B"):
            bs = sl["type"] == "B"
            nr, nr1 = sl["num_ref"], sl["num_ref1"]
            override = nr != p["num_ref_default"] or (bs and nr1 != p.get("num_ref_default1", 1))
            b.flag(override)
            if override:
                b.ue(nr - 1)
                if bs:
                    b.ue(nr1 - 1)
            total = sum(u for _, u in pl["rps"]["neg"] + pl["rps"]["pos"])
            if p["lists_mod"] and total > 1:
                for sfx in ("", "1") if bs else ("",):
                    b.flag(pl["entries" + sfx] is not None)
                    if pl["entries" + sfx] is not None:
                        for e in pl["entries" + sfx]:
                            b.u(e, (total - 1).bit_length())
            if bs:
                b.flag(sl["mvd_l1_zero"])
            if p["cabac_init_present"]:
                b.flag(sl["cabac_init"])
            if pl.get("tmvp"):
                col_l0 = pl.get("col_l0", True)
                if bs:
                    b.flag(col_l0)
                if (nr if col_l0 else nr1) > 1:
                    b.ue(pl["col"])
            if (p["weighted"] and not bs) or (p.get("weighted_bipred") and bs):
                ld, cd, *lists = sl["weights"]
                b.ue(ld)
                b.se(cd - ld)
                for w in lists:
                    for lw, _ in w:
                        b.flag(lw is not None)
                    for _, cw in w:
                        b.flag(cw is not None)
                    for lw, cw in w:
                        if lw is not None:
                            b.se(lw[0])
                            b.se(lw[1])
                        if cw is not None:
                            for dw, do in cw:
                                b.se(dw)
                                b.se(do)
            b.ue(5 - sl["max_merge"])
        b.se(sl["qp"] - p["init_qp"])
        if p["slice_cqp"]:
            b.se(sl["cqp"][0])
            b.se(sl["cqp"][1])
        ctrl = p["dbk_ctrl"]
        if ctrl is not None and ctrl[0]:
            b.flag(sl["dbk"] is not None)
            if sl["dbk"] is not None:
                b.flag(sl["dbk"][0])
                if not sl["dbk"][0]:
                    b.se(sl["dbk"][1])
                    b.se(sl["dbk"][2])
        if sl["lf_coded"]:
            b.flag(sl["lf_across"])
        # entry points: the substreams' sizes in the NAL unit, emulation prevention counted
        data = b"".join(subs)
        bounds = np.cumsum([len(s) for s in subs])[:-1].tolist()
        escaped, pos = _escape(data, [0] + bounds)
        starts = [pos[0]] + [pos[v] for v in bounds] + [len(escaped)]
        sizes = [starts[i + 1] - starts[i] for i in range(len(subs) - 1)]
        if p["wpp"]:
            b.ue(len(sizes))
            if sizes:
                nb = max(max(sizes).bit_length(), 1) + int(self.rng.integers(0, 3))
                b.ue(nb - 1)
                for v in sizes:
                    b.u(v - 1, nb)
        if p["header_ext"]:
            n = int(self.rng.integers(0, 3))
            b.ue(n)
            for _ in range(n):
                b.u(int(self.rng.integers(0, 256)), 8)
        b.u(1, 1)  # byte_alignment()
        b.align_zero()
        head = int("".join(b.parts), 2).to_bytes(b.n // 8, "big")
        return nal(pl["typ"], head + data)


def schedule(n: int, gop: int, rng, nonref: float = 0.0, cra: float = 0.0) -> list:
    """Picture kinds in decoding order: an IDR picture every ``gop`` (or a
    CRA picture, by chance ``cra``), P pictures between, ``nonref`` of them
    referenced by no later picture."""
    out = []
    for k in range(n):
        if k == 0 or (gop and k % gop == 0):
            out.append("CRA" if k and rng.random() < cra else "IDR")
        else:
            out.append("N" if rng.random() < nonref else "P")
    return out


# IRAP styles of ``b_schedule``: the NAL type of the IRAP picture and of the
# pictures between the anchor before it and it (None: coded before it)
IRAP_STYLES = {"idr": (IDR_N_LP, None), "idr-radl": (IDR_W_RADL, "RADL"),
               "cra-rasl": (CRA, "RASL"), "cra-radl": (CRA, "RADL"),
               "bla-rasl": (BLA_W_LP, "RASL"), "bla-radl": (BLA_W_RADL, "RADL"),
               "bla": (BLA_N_LP, None)}


def b_schedule(n: int, gop: int, bframes: int, rng, pyramid: bool = True, styles=("idr",),
               max_ref: int = 2, b_ref: float = 0.2, poc_step: int = 1,
               idr_after_cra: bool = False) -> list:
    """``n`` pictures in decoding order as x265 orders them: anchors (I or P)
    ``bframes`` + 1 apart in display order, an IRAP picture every ``gop``,
    each anchor followed by the B pictures before it in display order (with
    ``pyramid`` the middle one first, a reference, then each half the same
    way; else all of them in order, ``b_ref`` of them references).  Each
    IRAP picture takes a style of ``styles`` (``IRAP_STYLES``): its B
    pictures coded before it behind a P anchor ("idr", "bla"), or after it
    as RASL pictures (which predict from the pictures before it) or RADL
    pictures (which predict from it and each other).  A picture predicts
    from up to ``max_ref`` references before it and one after it in display
    order among those it may use (trailing pictures: none before their
    IRAP picture in decoding order, no leading picture).

    Each is a dict: ``disp``, ``kind`` ("I", "P", "B"), ``typ``, ``poc``
    (from the last IDR picture, times ``poc_step``), ``ref``, ``used`` and
    ``keep`` (POCs of the references it predicts from and of those it
    keeps for later pictures: together its RPS)."""
    out, anchors = [], []
    irap_at = set(range(0, n, gop)) if gop else {0}
    d = 0
    while d < n - 1:  # anchors in display order
        nxt = min(d + bframes + 1, n - 1, min((g for g in irap_at if g > d), default=n))
        anchors.append(nxt)
        d = nxt
    idr_disp = 0  # the display index of the last IDR picture

    def add(disp, kind, typ, ref, group, lead=None):  # group: its IRAP picture's decoding index
        out.append(dict(disp=disp, kind=kind, typ=typ, ref=ref, group=group, lead=lead,
                        poc=(disp - idr_disp) * poc_step))

    add(0, "I", IDR_W_RADL if rng.random() < 0.5 else IDR_N_LP, True, 0)
    prev, anchor_typ = 0, out[0]["typ"]
    for a in anchors:
        between = list(range(prev + 1, a))
        lead, typ = None, None
        if a in irap_at:
            style = styles[int(rng.integers(0, len(styles)))]
            if style.startswith("idr") and anchor_typ in (CRA, BLA_W_LP, BLA_W_RADL, BLA_N_LP) \
                    and not idr_after_cra:
                # libavcodec, decoding from that CRA or BLA picture, would drop an
                # IDR picture whose POC equals a picture its RPS generated
                # (``idr_after_cra`` keeps the IDR picture: ROADMAP Queue 3 item 27)
                style = "cra-radl"
            typ, lead = IRAP_STYLES[style]
            if lead is None and between:  # the pictures between, behind a P anchor before it
                p_anchor = between.pop()
                add(p_anchor, "P", TRAIL_R, True, out[-1]["group"])
                _code_bs(add, between, pyramid, rng, b_ref, None, out[-1]["group"])
                between = []
            if typ in (IDR_W_RADL, IDR_N_LP):
                idr_disp = a
            add(a, "I", typ, True, len(out))
        else:
            add(a, "P", TRAIL_R, True, out[-1]["group"])
        anchor_typ = out[-1]["typ"]
        _code_bs(add, between, pyramid, rng, b_ref, lead, out[-1]["group"])
        prev = a
    # the references each picture may use, and those it uses
    for k, pic in enumerate(out):
        pic["used"] = []
        if pic["kind"] == "I":
            continue
        group = pic["group"]
        allowed = []
        for j in range(k):
            q = out[j]
            if not q["ref"]:
                continue
            own = q["group"] == group and (j == group or q["lead"] == pic["lead"])
            if pic["lead"] == "RADL" and not own:  # its IRAP picture and its fellows
                continue
            if pic["lead"] == "RASL" and not (own or (q["lead"] is None and j < group and
                                                      q["group"] == out[group - 1]["group"])):
                continue  # and the trailing pictures of the IRAP picture before
            if pic["lead"] is None and (q["lead"] is not None or j < group):
                continue
            allowed.append(q)
        before = sorted([q for q in allowed if q["disp"] < pic["disp"]], key=lambda q: -q["disp"])
        after = sorted([q for q in allowed if q["disp"] > pic["disp"]], key=lambda q: q["disp"])
        used = before[:int(rng.integers(1, max_ref + 1))] + after[:1]
        if not used:
            used = (before + after)[:1]
        pic["used"] = [q["poc"] for q in used]
        pic["used_idx"] = [out.index(q) for q in used]
    # what each picture keeps: the references decoded before it that it or
    # a later picture uses
    for k, pic in enumerate(out):
        later = {j for q in out[k:] for j in q.get("used_idx", [])}
        pic["keep"] = [out[j]["poc"] for j in sorted(later) if j < k]
        if 16 <= pic["typ"] <= 23 and pic["typ"] in (IDR_W_RADL, IDR_N_LP):
            pic["keep"] = []
    for pic in out:
        pic.pop("used_idx", None)
    return out


def _code_bs(add, disps, pyramid, rng, b_ref, lead, group) -> None:
    """The B pictures ``disps`` (display order) in coding order."""
    if not disps:
        return
    if pyramid:
        mid = disps[len(disps) // 2] if len(disps) > 1 else disps[0]
        ref = len(disps) > 1 or bool(rng.random() < b_ref)
        add(mid, "B", _b_type(lead, ref), ref, group, lead)
        i = disps.index(mid)
        _code_bs(add, disps[:i], pyramid, rng, b_ref, lead, group)
        _code_bs(add, disps[i + 1:], pyramid, rng, b_ref, lead, group)
        return
    for d in disps:
        ref = bool(rng.random() < b_ref)
        add(d, "B", _b_type(lead, ref), ref, group, lead)


def _b_type(lead, ref: bool) -> int:
    return {None: (TRAIL_N, TRAIL_R), "RASL": (RASL_N, RASL_R), "RADL": (RADL_N, RADL_R)}[lead][ref]


def schedule_limits(pics: list) -> tuple:
    """(sps_max_num_reorder_pics, sps_max_dec_pic_buffering) a schedule
    needs: the most pictures before one in decoding order and after it in
    output order, and the most references kept beside that many waiting."""
    reorder = max(sum(1 for q in pics[:k] if q["disp"] > p["disp"]) for k, p in enumerate(pics))
    kept = max(len(p["keep"]) + len(set(p["used"]) - set(p["keep"])) for p in pics)
    return reorder, min(kept + reorder + 1, 16)


def random_stream(width: int, height: int, n: int, seed: int, gop: int = 5, **kw) -> tuple:
    """(samples, options): ``n`` pictures of random syntax (each sample a list
    of NAL units, the parameter sets before the first; ``inband`` repeats
    them before every IRAP picture), an IRAP picture every ``gop`` (a CRA
    picture by chance ``cra``); ``hidden`` of the pictures with
    pic_output_flag 0, ``no_prior`` of the IRAP pictures with
    no_output_of_prior_pics_flag 1, ``extra_nals`` an AUD and an SEI around
    each sample's units.  ``kw`` fixes ``options``' settings; beside the
    SPS's and PPS's, the choosers' odds narrow a difference to a tool:
    ``p_skip``, ``p_intra``, ``p_merge``, ``p_cbf`` (P slices), ``parts``,
    ``sao_kinds``, ``eo_classes``, ``num_ref``, ``mvd``, ``far_mv``, ``big``
    and ``slice_over`` (slice settings)."""
    cra = kw.pop("cra", 0.3)
    inband = kw.pop("inband", False)
    extra = kw.pop("extra_nals", False)
    hidden = kw.pop("hidden", 0.0)  # pictures of pic_output_flag 0
    no_prior = kw.pop("no_prior", 0.0)  # IRAP pictures of no_output_of_prior_pics_flag 1
    if hidden:
        kw.setdefault("pps", {})["output_flag"] = True
    if kw.get("bframes"):
        return _random_b_stream(width, height, n, seed, gop, inband, extra, hidden, no_prior, **kw)
    o = options(width, height, seed, **kw)
    w = StreamWriter(o, seed)
    kinds = schedule(n, gop, w.rng, o["nonref"], cra)
    samples = []
    for k, kind in enumerate(kinds):
        units = w.parameter_sets() if k == 0 or (inband and kind in ("IDR", "CRA")) else []
        if extra:
            units = [nal(AUD, bytes([0x50]))] + units + [nal(SEI, bytes([5, 1, 0, 0x80]))]
        units += w.picture(kind, output=not (k and w.rng.random() < hidden),
                           no_output_of_prior=bool(w.rng.random() < no_prior))
        samples.append(units)
    return samples, o


def _random_b_stream(width, height, n, seed, gop, inband, extra, hidden, no_prior, **kw) -> tuple:
    """``random_stream`` with B pictures: a ``b_schedule`` of ``bframes``
    (``pyramid``, ``styles``, ``b_ref``) whose pictures, coded in decoding
    order, hold B slices (``p_in_b``: P slices among them; ``gpb``: B slices
    in P pictures), the SPS's reorder and DPB sizes as the schedule needs
    them (``reorder`` raises the first), its RPSs in the SPS too;
    ``start_cra`` cuts the stream to start at its first CRA picture (whose
    RASL pictures then predict from pictures the stream lacks).
    ``options["display"]`` gives each sample's display index."""
    rng = np.random.default_rng(20_000 + seed)
    pps_kw = dict(kw.pop("pps", {}))
    pps_kw.setdefault("weighted_bipred", bool(rng.random() < 0.4))
    pps_kw.setdefault("num_ref_default1", int(rng.integers(1, 3)))
    pyramid = kw.pop("pyramid", True)
    styles = kw.pop("styles", ("idr", "cra-rasl"))
    b_ref = kw.pop("b_ref", 0.2)
    start_cra = kw.pop("start_cra", False)
    idr_after_cra = kw.pop("idr_after_cra", False)
    kw.setdefault("log2_max_poc_lsb", int(rng.choice([5, 6, 8])))
    o = options(width, height, seed, **kw, pps=pps_kw)
    pics = b_schedule(n, gop, o["bframes"], rng, pyramid, styles, o["max_ref"], b_ref, o["poc_step"],
                      idr_after_cra)
    reorder, dpb = schedule_limits(pics)
    o["reorder"] = max(reorder, kw.get("reorder", 0))
    o["dpb"] = max(dpb, kw.get("dpb", 0), o["reorder"] + 1)
    far, anchor = 0, pics[0]
    for pic in pics:  # each POC within half the LSB range of prevTid0Pic's
        if pic["typ"] not in (IDR_W_RADL, IDR_N_LP, BLA_W_LP, BLA_W_RADL, BLA_N_LP):
            far = max(far, abs(pic["poc"] - anchor["poc"]))
        if pic["typ"] in (TRAIL_R, CRA, IDR_W_RADL, IDR_N_LP, BLA_W_LP, BLA_W_RADL, BLA_N_LP):
            anchor = pic
    while far >= 1 << (o["log2_max_poc_lsb"] - 1):
        o["log2_max_poc_lsb"] += 1
    # the schedule's sets of trailing pictures in the SPS too
    sets = []
    for pic in pics:
        if pic["kind"] != "I" and len(sets) < 8:
            deltas = sorted({r - pic["poc"] for r in pic["used"] + pic["keep"]})
            r = {"neg": [(d, int(d + pic["poc"] in pic["used"])) for d in reversed(deltas) if d < 0],
                 "pos": [(d, int(d + pic["poc"] in pic["used"])) for d in deltas if d > 0]}
            if r not in sets:
                sets.append(r)
    o["rps_sets"] = o["rps_sets"] + sets
    w = StreamWriter(o, seed)
    samples = []
    for k, pic in enumerate(pics):
        irap = 16 <= pic["typ"] <= 23
        units = w.parameter_sets() if k == 0 or (inband and irap) else []
        if extra:
            units = [nal(AUD, bytes([0x50]))] + units + [nal(SEI, bytes([5, 1, 0, 0x80]))]
        units += w.coded_picture(pic, output=not (k and w.rng.random() < hidden),
                                 no_output_of_prior=bool(irap and w.rng.random() < no_prior))
        samples.append(units)
    o["display"] = [p["disp"] for p in pics]
    o["pictures"] = pics
    if start_cra:
        k = next(i for i, p in enumerate(pics) if p["typ"] == CRA)
        samples = [w.parameter_sets() + samples[k]] + samples[k + 1:]
        first = min(o["display"][k:])
        o["display"] = [d - first for d in o["display"][k:]]
        o["pictures"] = pics[k:]
    return samples, o


# --- an encoder of real content -------------------------------------------------------


def _smooth_options(width, height, seed, qp, **kw) -> dict:
    base = dict(log2_ctb=5, log2_min_cb=3, log2_max_tb=5, amp=False, sao=False, tmvp=False,
                strong=False, max_ref=1, depth_inter=0, depth_intra=0, slices=1, nonref=0.0,
                intra_in_p=0.0, log2_max_poc_lsb=8, poc_step=1, gpb=0.0, p_in_b=0.0)
    pps_kw = dict(sdh=False, cu_qp_delta=False, ts=False, cip=False, weighted=False, wpp=True,
                  dbk_ctrl=(False, True, 0, 0), lists_mod=False, init_qp=qp, num_ref_default=1,
                  extra_bits=0, header_ext=False, cabac_init_present=False, output_flag=False,
                  slice_cqp=False, cqp=[0, 0], par_mrg=2, weighted_bipred=False,
                  num_ref_default1=1)
    pps_kw.update(kw.pop("pps", {}))
    return options(width, height, seed, **{**base, **kw, "pps": pps_kw})


def _smooth_b_stream(width, height, n, seed, step, qp, gop, bframes, **kw) -> tuple:
    styles = kw.pop("styles", ("cra-rasl",))
    o = _smooth_options(width, height, seed, qp, **kw)
    src = hf.smooth_yuv(o["width"], o["height"], n, seed, step, o.get("bit_depth", 8))
    pics = b_schedule(n, gop, bframes, np.random.default_rng(seed), True, styles, 1, 0.0, 1)
    o["reorder"], o["dpb"] = schedule_limits(pics)
    w = StreamWriter(o, seed)
    enc = SmoothEncoder(o.get("bit_depth", 8))
    recs = {}  # display index -> the decoder's reconstruction
    disp_of = {}  # POC -> display index, by the schedule
    samples = []
    for k, pic in enumerate(pics):
        d = pic["disp"]
        disp_of[pic["poc"]] = d
        frame = [p[d] for p in src]
        enc.rec = [np.zeros_like(p) for p in frame]
        before = sorted((disp_of[r] for r in pic["used"] if disp_of[r] < d), reverse=True)
        after = sorted(disp_of[r] for r in pic["used"] if disp_of[r] > d)
        r0, r1 = (before + after)[0] if pic["used"] else None, (after + before)[0] if pic["used"] else None
        enc.ref = recs.get(r0)
        enc.ref1 = recs.get(r1)
        kind = "I" if pic["kind"] == "I" else pic["kind"]
        w.rng = np.random.default_rng(seed * 1000 + k)  # slice settings: fixed below

        def chooser(sl, frame=frame, kind=kind, r0=r0, r1=r1, d=d):
            sl.update(qp=qp, sao_luma=False, sao_chroma=False, max_merge=5, dbk=None, cqp=[0, 0],
                      lf_coded=False, cabac_init=False, num_ref=1, num_ref1=1, mvd_l1_zero=False,
                      type=kind)
            mv = None if r0 is None else (4 * step * (d - r0), 0)
            mv1 = None if r1 is None else (4 * step * (d - r1), 0)
            return SmoothChooser(enc, sl, frame, mv, mv1)
        samples.append((w.parameter_sets() if k == 0 else []) + w.coded_picture(pic, chooser))
        recs[d] = enc.rec
    o["display"] = [p["disp"] for p in pics]
    o["pictures"] = pics
    return samples, o


_LEVEL_SCALE = [40, 45, 51, 57, 64, 72]
_DCT_MAG = [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67, 64,
            61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0]


def dct_matrix(n: int) -> np.ndarray:
    """The N-point transMatrix (8.6.4.2), rows by frequency."""
    t = np.zeros((n, n), np.int64)
    step = 32 // n
    for k in range(n):
        for i in range(n):
            kk = k * step
            j = ((2 * i + 1) * kk) % 128
            f = j % 64
            f = 64 - f if f > 32 else f
            v = 64 if kk == 0 else _DCT_MAG[f]
            t[k, i] = -v if 32 < j < 96 else v
    return t


def chroma_qp(qp: int) -> int:
    return qp if qp < 30 else qp - 6 if qp > 43 else \
        [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37][qp - 30]


def dequantise(levels: np.ndarray, qp: int, log2: int, bd: int = 8) -> np.ndarray:
    """Scaled coefficients of ``levels`` at Qp' ``qp`` (QpBdOffset included)."""
    shift = bd + log2 - 5
    d = (levels * 16 * (_LEVEL_SCALE[qp % 6] << (qp // 6)) + (1 << (shift - 1))) >> shift
    return np.clip(d, -32768, 32767)


def inverse_transform(d: np.ndarray, log2: int, bd: int = 8) -> np.ndarray:
    """The decoder's residual of dequantised coefficients ``d`` [y, x]."""
    t = dct_matrix(1 << log2)
    g = np.clip((t.T @ d + 64) >> 7, -32768, 32767)
    return np.clip((g @ t + (1 << (19 - bd))) >> (20 - bd), -32768, 32767)


def quantise(res: np.ndarray, qp: int, log2: int, bd: int = 8) -> np.ndarray:
    """Levels whose dequantised inverse transform approximates ``res``."""
    n = 1 << log2
    t = dct_matrix(n).astype(np.float64)
    d = (t @ res @ t.T) * (2.0 ** (27 - bd)) / (4096.0 * n) ** 2
    f = 16 * (_LEVEL_SCALE[qp % 6] << (qp // 6)) / 2.0 ** (bd + log2 - 5)
    x = d / f
    return (np.sign(x) * np.floor(np.abs(x) + 0.4)).astype(np.int64)


class SmoothChooser:
    """An encoder's decisions for one slice of a picture of ``frame``: intra
    DC CUs (I) or CUs at the pan's vector ``mv`` (P; the first through AMVP
    from a zero predictor, the rest merged from a neighbour, skipped where
    no residual is left), or bi-predicted from two references at their
    vectors ``mv`` and ``mv1`` (B: the average of both), each CU one
    transform block, its residual coded at the slice's QP; ``rec`` (the
    picture being reconstructed) is updated as the decoder reconstructs it
    (no in-loop filter runs)."""

    def __init__(self, enc: "SmoothEncoder", sl: dict, frame, mv, mv1=None):
        self.enc, self.sl, self.frame, self.mv, self.mv1 = enc, sl, frame, mv, mv1
        self.qp = sl["qp"]
        self.levels_of = {}
        self.first = True

    def sao(self, a, can_left, can_up):
        raise AssertionError("the smooth streams run no SAO")

    def split(self, x0, y0, log2, depth) -> bool:
        return False

    def tsplit(self, x0, y0, log2, depth) -> bool:
        return False

    def _code(self, pred: list, x0: int, y0: int, log2: int) -> bool:
        """Residuals of the CU's three blocks against ``pred``; whether any level is left."""
        enc, any_ = self.enc, False
        bd, off = enc.bd, 6 * (enc.bd - 8)
        self.levels_of = {}
        for c in range(3):
            s = 0 if c == 0 else 1
            xc, yc, lc = x0 >> s, y0 >> s, log2 - s
            n = 1 << lc
            qp = (self.qp if c == 0 else chroma_qp(max(self.qp, -off))) + off  # Qp'
            src = self.frame[c][yc:yc + n, xc:xc + n].astype(np.int64)
            lv = quantise((src - pred[c]).astype(np.float64), qp, lc, bd)
            rec = pred[c]
            if lv.any():
                rec = pred[c] + inverse_transform(dequantise(lv, qp, lc, bd), lc, bd)
                any_ = True
                self.levels_of[c] = lv
            enc.rec[c][yc:yc + n, xc:xc + n] = np.clip(rec, 0, (1 << bd) - 1)
        return any_

    def cu(self, x0, y0, log2, depth, w) -> dict:
        enc = self.enc
        if self.sl["type"] == "I":
            pred = [enc.dc(c, x0 >> (c > 0), y0 >> (c > 0), log2 - (c > 0)) for c in range(3)]
            self._code(pred, x0, y0, log2)
            return {"skip": False, "intra": True, "part": PART_2Nx2N, "modes": [1], "chroma": 4}
        pred = [enc.shifted(c, x0 >> (c > 0), y0 >> (c > 0), (1 << log2) >> (c > 0), self.mv)
                for c in range(3)]
        if self.sl["type"] == "B":  # the default weighted average of both
            pred = [(p + enc.shifted(c, x0 >> (c > 0), y0 >> (c > 0), (1 << log2) >> (c > 0), self.mv1,
                                     enc.ref1) + 1) >> 1 for c, p in enumerate(pred)]
        coded = self._code(pred, x0, y0, log2)
        if self.first:
            self.first = False
            pu = {"merge": False, "ref": 0, "mvd": list(self.mv), "mvp": 0}
            if self.sl["type"] == "B":
                pu.update(dir=PRED_BI, ref1=0, mvd1=list(self.mv1), mvp1=0)
            return {"skip": False, "intra": False, "part": PART_2Nx2N, "root_cbf": coded,
                    "pus": [pu]}
        if not coded:
            return {"skip": True, "pus": [{"merge": True, "idx": 0}]}
        return {"skip": False, "intra": False, "part": PART_2Nx2N,
                "pus": [{"merge": True, "idx": 0}]}

    def cbf(self, x0, y0, log2, depth, c, split) -> bool:
        return c in self.levels_of

    def qp_delta(self) -> int:
        raise AssertionError("the smooth streams code no cu_qp_delta")

    def levels(self, x0, y0, log2, c):
        return self.levels_of[c]


class SmoothEncoder:
    """The reconstruction the decoder makes of a smooth stream, and the
    predictions its choices read."""

    def __init__(self, bd: int = 8):
        self.bd = bd
        self.rec = None
        self.ref = self.ref1 = None  # the pictures lists 0 and 1 start with

    def dc(self, c: int, x0: int, y0: int, log2: int) -> np.ndarray:
        """Intra DC prediction of a block (8.4.4.2.5): the neighbours above and
        to the left (substituted where the picture ends), the edge filter on
        luma below 32x32."""
        n = 1 << log2
        p = self.rec[c]
        top = p[y0 - 1, x0:x0 + n].astype(np.int64) if y0 else None
        left = p[y0:y0 + n, x0 - 1].astype(np.int64) if x0 else None
        if top is None and left is None:
            top = left = np.full(n, 1 << (self.bd - 1), np.int64)
        elif top is None:
            top = np.full(n, left[0], np.int64)
        elif left is None:
            left = np.full(n, top[0], np.int64)
        dc = (int(top.sum()) + int(left.sum()) + n) >> (log2 + 1)
        out = np.full((n, n), dc, np.int64)
        if c == 0 and n < 32:
            out[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            out[0, 1:] = (top[1:] + 3 * dc + 2) >> 2
            out[1:, 0] = (left[1:] + 3 * dc + 2) >> 2
        return out

    def shifted(self, c: int, x0: int, y0: int, n: int, mv, ref=None) -> np.ndarray:
        """A block of the reference picture (``ref``, else list 0's first)
        moved by integer vector ``mv`` (quarter luma samples, multiples of
        8), the edge extended."""
        p = (ref or self.ref)[c]
        f = 4 if c == 0 else 8
        H, W = p.shape
        ys = np.clip(np.arange(y0, y0 + n) + mv[1] // f, 0, H - 1)
        xs = np.clip(np.arange(x0, x0 + n) + mv[0] // f, 0, W - 1)
        return p[ys][:, xs].astype(np.int64)


def smooth_stream(width: int, height: int, n: int, seed: int, step: int = 4, qp: int = 30,
                  gop: int = 0, bframes: int = 0, **kw) -> tuple:
    """(samples, options): a seeded smooth field panning ``step`` pixels a
    frame (``torch_h264_files.smooth_yuv``), coded as an IDR picture of
    intra DC CUs, then P pictures at the pan's vector (x265's defaults where
    the clip reaches them: 32x32 CTBs here, WPP), the residual coded at a
    fixed QP, deblocking and SAO off so that the encoder's reconstruction is
    the decoder's; an IDR picture every ``gop`` (0: only the first).  With
    ``bframes``, x265's default structure: anchors ``bframes`` + 1 apart,
    hierarchical B pictures between, each bi-predicted from the nearest
    reference before and after it, and every ``gop`` an open-GOP CRA
    picture whose B pictures before it are RASL pictures (``styles`` of
    ``b_schedule`` for others); the samples then in decoding order,
    ``options["display"]`` each one's display index."""
    assert step % 2 == 0, "an even step keeps the chroma vector whole"
    if bframes:
        return _smooth_b_stream(width, height, n, seed, step, qp, gop, bframes, **kw)
    o = _smooth_options(width, height, seed, qp, **kw)
    src = hf.smooth_yuv(o["width"], o["height"], n, seed, step, o.get("bit_depth", 8))
    w = StreamWriter(o, seed)
    enc = SmoothEncoder(o.get("bit_depth", 8))
    mv = (4 * step, 0)
    samples = []
    for k in range(n):
        frame = [p[k] for p in src]
        enc.rec = [np.zeros_like(p) for p in frame]
        kind = "IDR" if k == 0 or (gop and k % gop == 0) else "P"
        w.rng = np.random.default_rng(seed * 1000 + k)  # slice settings: fixed below
        units = w.parameter_sets() if k == 0 else []

        def chooser(sl, frame=frame):
            sl.update(qp=qp, sao_luma=False, sao_chroma=False, max_merge=5, dbk=None, cqp=[0, 0],
                      lf_coded=False, cabac_init=False, num_ref=1, type="I" if kind == "IDR" else "P")
            return SmoothChooser(enc, sl, frame, mv)
        units += w.picture(kind, chooser, nal_type=IDR_W_RADL)
        samples.append(units)
        enc.ref = enc.rec
    return samples, o


class _NoResidualChooser(SmoothChooser):
    """``SmoothChooser``'s inter CUs at its vectors (half samples allowed),
    coded without residual: the picture is the prediction alone.  In an I
    picture the luma block at ``spike`` takes levels whose residual
    saturates 16 bits at its top-left sample (every coefficient at the
    largest dequantised value, signed as the transform's first column)."""

    spike = None

    def _code(self, pred, x0, y0, log2) -> bool:
        if self.sl["type"] == "I":
            coded = super()._code(pred, x0, y0, log2)
            if (x0, y0) == self.spike:
                bd = self.enc.bd
                qp = self.qp + 6 * (bd - 8)
                step = 16 * (_LEVEL_SCALE[qp % 6] << (qp // 6)) / 2.0 ** (bd + log2 - 5)
                sign = np.sign(dct_matrix(1 << log2)[:, 0])
                self.levels_of[0] = (np.outer(sign, sign) * -(-32768 // step)).astype(np.int64)
                coded = True
            return coded
        self.levels_of = {}
        return False

    def cu(self, x0, y0, log2, depth, w) -> dict:
        if self.sl["type"] != "I" and self.first:
            return self._first_pu()
        return super().cu(x0, y0, log2, depth, w)

    def _first_pu(self) -> dict:
        self.first = False
        pu = {"merge": False, "ref": 0, "mvd": list(self.mv), "mvp": 0}
        if self.sl["type"] == "B":
            pu.update(dir=PRED_BI, ref1=0, mvd1=list(self.mv1), mvp1=0)
        return {"skip": False, "intra": False, "part": PART_2Nx2N, "root_cbf": False, "pus": [pu]}


def extreme_stream(width: int, height: int, bit_depth: int = 10, qp: int = 12) -> tuple:
    """(samples, options): the predictions at the edges of 16 bits.  An IDR
    picture of 0 and the largest sample in the 8x8 pattern where the 8-tap
    half-sample filter peaks both ways (``a(x) == a(y)``, a = 01011010),
    coded from targets past the range so that the reconstruction clips to
    it exactly, but for its last 32x32 block, whose residual saturates 16
    bits (libavcodec's 10-bit SIMD code wraps the sum with the prediction
    in 16 bits, its C code clips it); then a
    B picture bi-predicted from it at half-sample vectors (2, 2) and
    (2, 18), the first past 16 bits before its shift (libavcodec's SIMD
    code saturates it at 8 and 10 bits, its C code wraps it at 9), the
    second four rows on (the pattern's complement), without residual."""
    top = (1 << bit_depth) - 1
    o = _smooth_options(width, height, 0, qp, log2_ctb=5, log2_max_tb=5, bit_depth=bit_depth)
    a = np.array([0, 1, 0, 1, 1, 0, 1, 0])

    def plane(h, w):
        on = a[np.arange(h)[:, None] % 8] == a[np.arange(w)[None, :] % 8]
        return np.where(on, top + top // 4, -(top // 4)).astype(np.int64)
    frame = [plane(o["height"], o["width"]), plane(o["height"] // 2, o["width"] // 2),
             plane(o["height"] // 2, o["width"] // 2)]
    pics = [dict(disp=0, kind="I", typ=IDR_W_RADL, poc=0, used=[], keep=[]),
            dict(disp=1, kind="B", typ=TRAIL_R, poc=1, used=[0], keep=[0])]
    o["reorder"], o["dpb"] = 0, 2
    w = StreamWriter(o, 0)
    enc = SmoothEncoder(bit_depth)
    enc.rec = [np.zeros_like(p) for p in frame]
    samples = []
    for k, pic in enumerate(pics):
        w.rng = np.random.default_rng(k)

        def chooser(sl, kind=pic["kind"]):
            sl.update(qp=qp, sao_luma=False, sao_chroma=False, max_merge=5, dbk=None, cqp=[0, 0],
                      lf_coded=False, cabac_init=False, num_ref=1, num_ref1=1, mvd_l1_zero=False,
                      type=kind)
            ch = _NoResidualChooser(enc, sl, frame, (2, 2), (2, 18))
            ch.spike = (o["width"] - 32, o["height"] - 32)  # the last CU: nothing reads it later
            return ch
        samples.append((w.parameter_sets() if k == 0 else []) + w.coded_picture(pic, chooser))
        enc.ref = enc.ref1 = enc.rec
    o["display"] = [0, 1]
    return samples, o

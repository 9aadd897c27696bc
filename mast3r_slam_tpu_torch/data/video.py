"""Video files without cv2: the containers and the dataset (port of
``MP4Dataset``, ``mast3r_slam_tpu/data/dataloader.py:245-275``).

The JAX package reads ``.mp4``, ``.mov`` and ``.avi`` through
``cv2.VideoCapture`` (FFmpeg).  Here the container is walked in Python
(``read_track``: ISO BMFF boxes or RIFF AVI chunks, into a table of
sample offsets, sizes and sync flags) and each sample is decoded by the
host library's MPEG-4 Part 2, H.264, HEVC or Motion-JPEG decoder
(``csrc/host/mpeg4.cpp``, ``h264.cpp``, ``hevc.cpp``, ``mjpeg.cpp`` through
``utils/native.Mpeg4Decoder``, ``H264Decoder``, ``HevcDecoder``,
``MjpegDecoder``), which gives the frame that ``cv2.cvtColor(cap.read()[1],
cv2.COLOR_BGR2RGB)`` gives with cv2 5.0.0; the frame is then turned by
the track's display matrix as cv2 turns it (``Track.rotation``).
``len``, ``fps`` and the timestamps are the ones cv2 reports:
``CAP_PROP_FRAME_COUNT`` is the container's sample count, ``CAP_PROP_FPS``
the constant sample rate (timescale over the one ``stts`` delta, or AVI's
``dwRate / dwScale``).  H.264 pictures come out as libavcodec outputs
them under cv2: held back and reordered (B pictures), by the output
delay cv2's decoder starts with (``MP4Dataset._probe_delay``) and grows,
its frame threads decoding ahead (``FRAME_THREADS``), drained at the end
of the file.  HEVC pictures (``hvc1``/``hev1``, or the AVI fourccs FFmpeg
maps to HEVC; I, P and B pictures, RADL, RASL and BLA pictures) come out
as the DPB's output process releases them, which the SPS alone steers,
with the same frame threads ahead; the RASL pictures of a CRA or BLA
picture that opens decoding (the file's first sample, or a seek's) are
left out as libavcodec leaves them out, so cv2 and the port then show
fewer frames than the samples.  In ISO BMFF a frame's number is its
presentation time (``ctts``) from the edit's start; frames outside the one
edit are decoded and not shown (``Track.frames``).  A read away from the
next frame seeks as cv2 does (``MP4Dataset._seek``), its sync sample
found as FFmpeg's demuxer finds it (``MP4Dataset._seek_sample``), frames
counted from the first one the file shows.  Motion-JPEG (the AVI
fourccs FFmpeg maps to it and reads as it reads MJPG, a ``jpeg`` sample
entry, or ``mp4v`` of objectTypeIndication 0x6C) has a picture a sample,
every one a sync sample; an empty AVI chunk (a dropped frame) counts in
the frame count and shows nothing, so cv2's later frames come one early.

What is not ported raises ``NotImplementedError`` naming ROADMAP Queue 1
item 17, and never falls back to cv2: video codecs other than MPEG-4
Part 2, H.264, HEVC and Motion-JPEG (AV1, MS-MPEG4, FFV1, ...), the
Motion-JPEG fourccs, sample entries and pictures libavcodec treats apart
(item 17f: ``mjpeg.cpp`` lists the pictures), sample
durations that are not one constant run (FFmpeg guesses a rate from
them), composition times that are not distinct whole frames, edit lists
of several edits, empty edits or another rate, MPEG-4 Part 2 B-VOPs
(``ctts``), H.264 sync samples that are not IDR pictures, HEVC ones that
are not IRAP pictures (IDR, CRA or BLA, leading pictures or not), and the
stream features the decoders refuse.  A damaged file raises
``ValueError``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import mmap
import os
import pathlib
import struct
from typing import Optional

import numpy as np

from ..utils import native
from .dataloader import MonocularDataset

ROADMAP_ITEM = "ROADMAP Queue 1 item 17"
# the frame threads cv2 has libavcodec run: one a CPU online (its
# get_number_of_cpus); an H.264 frame comes back after FRAME_THREADS - 1
# more samples went in
FRAME_THREADS = max(os.sysconf("SC_NPROCESSORS_ONLN"), 1)
# MPEG-4 Part 2, H.264 and HEVC under the fourccs FFmpeg's AVI demuxer maps
# to them (riff.c ff_codec_bmp_tags, matched upper-cased)
AVI_MPEG4_FOURCCS = {b"XVID", b"DIVX", b"DX50", b"FMP4", b"MP4V"}
AVI_H264_FOURCCS = {b"H264", b"X264", b"AVC1", b"DAVC", b"SMV2", b"VSSH", b"Q264", b"V264",
                    b"GAVC", b"UMSV", b"TSHD", b"INMC"}
H264_ENTRIES = {b"avc1", b"avc3"}  # ISO BMFF sample entries of H.264 read here
AVI_HEVC_FOURCCS = {b"HEVC", b"H265", b"HEV1", b"HVC1"}
HEVC_ENTRIES = {b"hvc1", b"hev1"}  # ISO BMFF sample entries of HEVC read here
# the AVI fourccs cv2 reads as Motion-JPEG exactly as it reads MJPG; those
# libavcodec decodes apart (a height cut to the container's, CJPG's scan
# header, lossless and JPEG-LS ids, MTSJ's swapped chroma) are refused
AVI_MJPEG_FOURCCS = {b"MJPG", b"AVI1", b"AVI2", b"MJPA", b"JR24", b"ACDV", b"QIVG", b"SLMJ",
                     b"IJPG", b"JPGL", b"JPEG", b"DMB1", b"ZJPG", b"MMJP"}
AVI_MJPEG_REFUSED = {b"AVRN", b"AVDJ", b"CJPG", b"LJPG", b"MJLS", b"MTSJ"}
MJPEG_ENTRY = b"jpeg"  # the ISO BMFF sample entry of Motion-JPEG read here
MJPEG_REFUSED_ENTRIES = {b"mjpa", b"mjpb", b"AVDJ", b"AVRn", b"dmb1"}
MJPEG_ITEM = "ROADMAP Queue 1 item 17f"
MPEG4_VISUAL = 0x20  # esds objectTypeIndication of MPEG-4 Part 2 (ISO/IEC 14496-1)
MJPEG_OTI = 0x6C  # esds objectTypeIndication FFmpeg maps to Motion-JPEG
VOP_START = b"\x00\x00\x01\xb6"


@dataclasses.dataclass
class Track:
    """A video track's samples as the container lists them."""

    config: bytes  # the decoder configuration, empty if in-band: MPEG-4's VOS/VOL
    # headers, or H.264's or HEVC's parameter sets as Annex B NAL units
    offsets: np.ndarray  # int64 byte offsets of the samples in the file
    sizes: np.ndarray  # int64 byte sizes
    sync: np.ndarray  # bool, a sample decodable without the ones before it
    fps: float
    frame_count: int
    codec: str = "mpeg4"  # or "h264", "hevc"
    length_size: int = 0  # H.264, HEVC: bytes of a NAL unit's length (avcC, hvcC), 0 for Annex B
    rotation: int = 0  # degrees cv2 turns each frame clockwise: 0, 90, 180, 270
    # each sample's frame number as cv2 counts it (its presentation time
    # from the edit's start, in frames; -1 outside the edit: decoded, never
    # shown), None for the sample order (AVI, or MPEG-4 Part 2)
    frames: Optional[np.ndarray] = None
    video_delay: int = 0  # FFmpeg's reorder guess from the composition times (ctts)
    # each sample's decode time in frames from the presentation's start (what
    # FFmpeg's seek compares with the target), None for the sample order
    decode_times: Optional[np.ndarray] = None
    # what FFmpeg's mov_seek_stream adds to a target frame before it compares
    # decode times (its min_corrected_pts taken off, in frames)
    seek_offset: float = 0.0
    # the frame size the container gives (Motion-JPEG: libavcodec's coded
    # size at open), 0 where it gives none
    width: int = 0
    height: int = 0


def _unsupported(what: str, item: str = ROADMAP_ITEM) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported ({item})")


# --- ISO BMFF (.mp4, .mov) -------------------------------------------------


def _boxes(data: bytes, start: int, end: int, path):
    at = start
    while at + 8 <= end:
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if size == 1:
            if at + 16 > end:
                raise ValueError(f"{path}: box {kind!r} at byte {at} is cut short")
            (size,) = struct.unpack(">Q", data[at + 8:at + 16])
            head = 16
        elif size == 0:
            size = end - at
        if size < head or at + size > end:
            raise ValueError(f"{path}: box {kind!r} at byte {at} is cut short")
        yield kind, at + head, at + size
        at += size


def _children(data, start, end, path) -> dict:
    out = {}
    for kind, a, b in _boxes(data, start, end, path):
        out.setdefault(kind, []).append((a, b))
    return out


def _full_box(data, a, b, fmt, path, kind):
    """The fields of a full box's body after its version and flags."""
    n = struct.calcsize(fmt)
    if a + 4 + n > b:
        raise ValueError(f"{path}: {kind} box is cut short")
    return data[a], struct.unpack(fmt, data[a + 4:a + 4 + n])


def _table(data, a, b, count_at, row, path, kind) -> np.ndarray:
    """A full box's table: a uint32 count at ``count_at`` then ``row``
    big-endian uint32 (or uint64 for ``co64``) columns a row."""
    (n,) = struct.unpack(">I", data[a + count_at:a + count_at + 4])
    wide = kind == "co64"
    item = 8 if wide else 4
    first = a + count_at + 4
    if first + n * row * item > b:
        raise ValueError(f"{path}: {kind} box holds fewer than its {n} entries")
    arr = np.frombuffer(data, dtype=">u8" if wide else ">u4", count=n * row, offset=first)
    return arr.astype(np.int64).reshape(n, row)


def _descriptor(data: bytes, at: int, end: int, path):
    """One MPEG-4 descriptor (ISO/IEC 14496-1 8.3.3): (tag, body start, body end)."""
    if at + 2 > end:
        raise ValueError(f"{path}: esds descriptor is cut short")
    tag = data[at]
    at += 1
    size = 0
    for _ in range(4):
        byte = data[at]
        at += 1
        size = (size << 7) | (byte & 0x7F)
        if not byte & 0x80:
            break
    if at + size > end:
        raise ValueError(f"{path}: esds descriptor {tag} is cut short")
    return tag, at, at + size


def _esds_config(data: bytes, a: int, b: int, path) -> tuple:
    """(the DecoderSpecificInfo of an ``esds`` box, the codec: "mpeg4" for
    MPEG-4 Part 2, "mjpeg" for JPEG); other objectTypeIndications are
    refused."""
    tag, s, e = _descriptor(data, a + 4, b, path)
    if tag != 3:
        raise ValueError(f"{path}: esds holds descriptor {tag}, not an ES_Descriptor")
    flags = data[s + 2]
    s += 3
    if flags & 0x80:  # streamDependenceFlag
        s += 2
    if flags & 0x40:  # URL_Flag
        s += 1 + data[s]
    if flags & 0x20:  # OCRstreamFlag
        s += 2
    tag, s, e = _descriptor(data, s, e, path)
    if tag != 4:
        raise ValueError(f"{path}: esds holds descriptor {tag}, not a DecoderConfigDescriptor")
    if data[s] not in (MPEG4_VISUAL, MJPEG_OTI):
        raise _unsupported(f"{path}: an mp4v track of objectTypeIndication 0x{data[s]:02x}")
    codec = "mpeg4" if data[s] == MPEG4_VISUAL else "mjpeg"
    at = s + 13
    while at < e:
        tag, ds, de = _descriptor(data, at, e, path)
        if tag == 5:
            return bytes(data[ds:de]), codec
        at = de
    return b"", codec


def _avcc_config(data: bytes, a: int, b: int, path) -> tuple:
    """(the parameter sets as Annex B NAL units, the NAL unit length size)
    of an ``avcC`` box (ISO/IEC 14496-15 5.3.3.1)."""
    if b - a < 7 or data[a] != 1:
        raise ValueError(f"{path}: an avcC box of version {data[a] if b > a else None}")
    length_size = (data[a + 4] & 3) + 1
    if length_size == 3:
        raise ValueError(f"{path}: an avcC NAL unit length of 3 bytes")
    units, at = [], a + 5
    for counted in (0x1F, 0xFF):  # the SPSs, then the PPSs
        (n,) = struct.unpack(">B", data[at:at + 1])
        at += 1
        for _ in range(n & counted):
            (size,) = struct.unpack(">H", data[at:at + 2])
            if at + 2 + size > b:
                raise ValueError(f"{path}: avcC parameter set cut short")
            units.append(b"\x00\x00\x00\x01" + bytes(data[at + 2:at + 2 + size]))
            at += 2 + size
    return b"".join(units), length_size


def _hvcc_config(data: bytes, a: int, b: int, path) -> tuple:
    """(the VPS, SPS, PPS and SEI NAL units as Annex B, the NAL unit length
    size) of an ``hvcC`` box (ISO/IEC 14496-15 8.3.3.1)."""
    if b - a < 23 or data[a] != 1:
        raise ValueError(f"{path}: an hvcC box of version {data[a] if b > a else None}")
    length_size = (data[a + 21] & 3) + 1
    if length_size == 3:
        raise ValueError(f"{path}: an hvcC NAL unit length of 3 bytes")
    units, at = [], a + 23
    for _ in range(data[a + 22]):  # numOfArrays
        if at + 3 > b:
            raise ValueError(f"{path}: hvcC array cut short")
        (n,) = struct.unpack(">H", data[at + 1:at + 3])
        at += 3
        for _ in range(n):
            (size,) = struct.unpack(">H", data[at:at + 2])
            if at + 2 + size > b:
                raise ValueError(f"{path}: hvcC parameter set cut short")
            units.append(b"\x00\x00\x00\x01" + bytes(data[at + 2:at + 2 + size]))
            at += 2 + size
    return b"".join(units), length_size


def _matrix(data: bytes, at: int) -> list:
    """The 3x3 display matrix of ``tkhd``/``mvhd`` at byte ``at``: rows of
    (16.16, 16.16, 2.30) fixed point."""
    v = struct.unpack(">9i", data[at:at + 36])
    return [list(v[0:3]), list(v[3:6]), list(v[6:9])]


def rotation(tkhd, mvhd) -> int:
    """The clockwise turn cv2 5.0.0 gives every frame of a track: FFmpeg's
    display matrix (``mov_read_tkhd``: the track's matrix times the
    movie's, each product shifted back by the row's fixed point) read by
    ``av_display_rotation_get``, negated and rounded as cv2 rounds it;
    cv2 turns only by 90, 180 and 270 (a mirror reads as 180; another
    angle, or a matrix without one, leaves the frame as it is)."""
    shifts = (16, 16, 30)
    m = [[sum((tkhd[i][e] * mvhd[e][j]) >> shifts[e] for e in range(3)) for j in range(3)]
         for i in range(3)]
    m = [((v + (1 << 31)) % (1 << 32)) - (1 << 31) for row in m for v in row]  # int32 wrap
    if m == [1 << 16, 0, 0, 0, 1 << 16, 0, 0, 0, 1 << 30]:
        return 0
    conv = [v / 65536.0 for v in m]
    scale0, scale1 = math.hypot(conv[0], conv[3]), math.hypot(conv[1], conv[4])
    if scale0 == 0.0 or scale1 == 0.0:
        return 0
    angle = -math.atan2(conv[1] / scale1, conv[0] / scale0) * 180 / math.pi
    turn = -round(angle)  # cvRound: to the nearest, halves to even, as round() does
    if turn < 0:
        turn += 360
    return turn if turn in (90, 180, 270) else 0


def _edit(data: bytes, kids: dict, path):
    """The track's one edit (segment duration in movie ticks, media time), or
    None without an edit list; FFmpeg's other edit lists are refused."""
    edits = []
    for ea, eb in kids.get(b"edts", []):
        for ka, kb in _children(data, ea, eb, path).get(b"elst", []):
            version, (n,) = _full_box(data, ka, kb, ">I", path, "elst")
            fmt = ">Qqhh" if version == 1 else ">Iihh"
            step = struct.calcsize(fmt)
            if ka + 8 + n * step > kb:
                raise ValueError(f"{path}: elst box holds fewer than its {n} entries")
            edits += [struct.unpack(fmt, data[ka + 8 + i * step:ka + 8 + (i + 1) * step])
                      for i in range(n)]
    if not edits:
        return None
    if len(edits) != 1 or edits[0][1] < 0 or edits[0][2:] != (1, 0):
        raise _unsupported(f"{path}: an edit list other than one edit of rate 1 (several "
                           f"edits, an empty edit or another rate)")
    return edits[0][0], edits[0][1]


def _guess_video_delay(pts: np.ndarray) -> int:
    """FFmpeg's ``mov_guess_video_delay``: the most pictures a sample's
    presentation time falls behind among the 16 it keeps of those before."""
    buf, delay = [np.iinfo(np.int64).min] * 17, 0
    for t in pts.tolist():
        buf.pop(0)  # its circular buffer drops its smallest entry for the new one
        delay = max(delay, sum(1 for v in buf if v > t))
        buf.insert(int(np.searchsorted(buf, t)), t)
    return delay


def _presentation(data: bytes, stbl: dict, kids: dict, count: int, delta: int, timescale: int,
                  movie_scale: int, path) -> tuple:
    """(each sample's frame number as cv2 counts it, FFmpeg's video_delay,
    each sample's decode time in frames from the presentation's start, the
    seek's offset of ``Track``): presentation times from
    the sample order and the composition offsets (``ctts``, version 0 or
    1), counted from the one edit's media time (else from the first);
    samples outside the edit (before its media time, or past its duration)
    are decoded but not shown (-1).  With an edit, FFmpeg's mov_fix_index
    counts decode times from the first sample shown (``j0``) and takes off
    the least presentation time shown, which mov_seek_stream takes off the
    target too."""
    ct = np.arange(count, dtype=np.int64) * delta
    ctts = None
    if b"ctts" in stbl:
        ca, cb = stbl[b"ctts"][0]
        rows = _table(data, ca, cb, 4, 2, path, "ctts")
        if data[ca] == 1:  # version 1: signed offsets
            rows[:, 1] = rows[:, 1].astype(np.uint32).astype(np.int32)
        if int(rows[:, 0].sum()) != count:
            raise ValueError(f"{path}: ctts counts {int(rows[:, 0].sum())} samples, stsz {count}")
        ctts = np.repeat(rows[:, 1], rows[:, 0])
        ct = ct + ctts
    edit = _edit(data, kids, path)
    if edit is None:
        start, end = int(ct.min()) if count else 0, None
    else:
        if movie_scale == 0:
            raise ValueError(f"{path}: a movie timescale of 0")
        start = edit[1]
        # av_rescale to the track's ticks, rounded to the nearest
        end = start + (edit[0] * timescale + movie_scale // 2) // movie_scale
    if np.any((ct - start) % delta) or len(np.unique(ct)) != count:
        raise _unsupported(f"{path}: composition times that are not distinct whole frames")
    frames = (ct - start) // delta
    outside = ct < start if end is None else (ct < start) | (ct >= end)
    frames[outside] = -1
    decode_times = (np.arange(count, dtype=np.int64) * delta - start) / delta
    seek_offset = 0.0
    shown = np.flatnonzero(~outside)
    if edit is not None and len(shown):
        seek_offset = (int(shown[0]) * delta - int(ct[shown].min())) / delta
    return frames, _guess_video_delay(ct) if ctts is not None else 0, decode_times, seek_offset


def _mp4_track(data: bytes, trak, path, mvhd, movie_scale: int) -> Optional[Track]:
    """The track in ``trak`` if it is video, else None."""
    a, b = trak
    kids = _children(data, a, b, path)
    mdia = _children(data, *kids[b"mdia"][0], path)
    hdlr_a, _ = mdia[b"hdlr"][0]
    if data[hdlr_a + 8:hdlr_a + 12] != b"vide":
        return None
    ma, mb = mdia[b"mdhd"][0]
    version = data[ma]
    timescale_at = ma + (20 if version == 1 else 12)
    (timescale,) = struct.unpack(">I", data[timescale_at:timescale_at + 4])
    stbl = _children(data, *_children(data, *mdia[b"minf"][0], path)[b"stbl"][0], path)
    sa, sb = stbl[b"stsd"][0]
    _, (n_entries,) = _full_box(data, sa, sb, ">I", path, "stsd")
    entries = list(_boxes(data, sa + 8, sb, path))
    if n_entries != 1 or len(entries) != 1:
        raise _unsupported(f"{path}: a video track of {n_entries} sample descriptions")
    fourcc, va, vb = entries[0]
    if fourcc in MJPEG_REFUSED_ENTRIES:
        raise _unsupported(f"{path}: Motion-JPEG of sample entry {fourcc.decode()!r}",
                           MJPEG_ITEM)
    if fourcc not in (b"mp4v", MJPEG_ENTRY) and fourcc not in H264_ENTRIES \
            and fourcc not in HEVC_ENTRIES:
        raise _unsupported(f"{path}: video of sample entry {fourcc.decode(errors='replace')!r}")
    config, codec, length_size = b"", "mpeg4" if fourcc == b"mp4v" else "mjpeg", 0
    width, height = struct.unpack(">HH", data[va + 24:va + 28])
    children = {kind: (ka, kb) for kind, ka, kb in _boxes(data, va + 78, vb, path)}
    if fourcc == b"mp4v" and b"esds" in children:
        config, codec = _esds_config(data, *children[b"esds"], path)
    elif fourcc in HEVC_ENTRIES:
        if b"hvcC" not in children:
            raise _unsupported(f"{path}: an {fourcc.decode()} track without an hvcC box")
        config, length_size = _hvcc_config(data, *children[b"hvcC"], path)
        codec = "hevc"
    elif fourcc in H264_ENTRIES:
        if b"avcC" not in children:
            raise _unsupported(f"{path}: an {fourcc.decode()} track without an avcC box")
        config, length_size = _avcc_config(data, *children[b"avcC"], path)
        codec = "h264"
    ta, _ = kids[b"tkhd"][0]
    turn = rotation(_matrix(data, ta + (52 if data[ta] == 1 else 40)), mvhd)
    stts = _table(data, *stbl[b"stts"][0], 4, 2, path, "stts")
    deltas = np.unique(stts[stts[:, 0] > 0, 1])
    if len(deltas) != 1 or deltas[0] == 0 or timescale == 0:
        raise _unsupported(f"{path}: sample durations {deltas.tolist()} that are not one "
                           f"constant run (FFmpeg's frame-rate guess)")
    sz_a, sz_b = stbl[b"stsz"][0]
    _, (fixed, count) = _full_box(data, sz_a, sz_b, ">II", path, "stsz")
    if fixed and fixed * count > len(data):
        raise ValueError(f"{path}: stsz lists {count} samples of {fixed} bytes")
    sizes = (np.full(count, fixed, np.int64) if fixed
             else _table(data, sz_a, sz_b, 8, 1, path, "stsz")[:, 0])
    if int(stts[:, 0].sum()) != count:
        raise ValueError(f"{path}: stts counts {int(stts[:, 0].sum())} samples, stsz {count}")
    co_kind = b"stco" if b"stco" in stbl else b"co64"
    chunks = _table(data, *stbl[co_kind][0], 4, 1, path, co_kind.decode())[:, 0]
    stsc = _table(data, *stbl[b"stsc"][0], 4, 3, path, "stsc")
    per_chunk = np.zeros(len(chunks), np.int64)
    for i, (first, n, _) in enumerate(stsc):
        last = stsc[i + 1, 0] - 1 if i + 1 < len(stsc) else len(chunks)
        if first < 1 or last > len(chunks):
            raise ValueError(f"{path}: stsc names chunk {first} of {len(chunks)}")
        per_chunk[first - 1:last] = n
    if int(per_chunk.sum()) != count:
        raise ValueError(f"{path}: stsc places {int(per_chunk.sum())} samples, stsz {count}")
    chunk_of = np.repeat(np.arange(len(chunks)), per_chunk)
    starts = np.cumsum(per_chunk) - per_chunk
    ends = np.cumsum(sizes)
    within = ends - sizes - (ends - sizes)[starts[chunk_of]]
    offsets = chunks[chunk_of] + within
    if b"stss" in stbl:
        sync = np.zeros(count, bool)
        idx = _table(data, *stbl[b"stss"][0], 4, 1, path, "stss")[:, 0] - 1
        if np.any((idx < 0) | (idx >= count)):
            raise ValueError(f"{path}: stss names a sample outside the track")
        sync[idx] = True
    else:
        sync = np.ones(count, bool)
    frames, delay, decode_times, seek_offset = _presentation(
        data, stbl, kids, int(count), int(deltas[0]), timescale, movie_scale, path)
    if codec == "mpeg4" and b"ctts" in stbl:
        raise _unsupported(f"{path}: MPEG-4 Part 2 with composition offsets (B-VOPs)")
    if codec == "mjpeg" and b"ctts" in stbl:
        raise _unsupported(f"{path}: Motion-JPEG with composition offsets", MJPEG_ITEM)
    return Track(config, offsets, sizes, sync, timescale / int(deltas[0]), int(count), codec,
                 length_size, turn, frames, delay, decode_times, seek_offset, width, height)


def _damaged(read):
    """``read`` raising ValueError where a box or chunk it needs is missing
    or cut short."""
    def checked(data, path=None):
        path = path or f"{read.__name__[5:].upper()} data"
        try:
            return read(data, path)
        except (KeyError, IndexError, struct.error) as e:
            raise ValueError(f"{path}: a damaged file ({type(e).__name__}: {e})") from e
    checked.__name__, checked.__doc__ = read.__name__, read.__doc__
    return checked


@_damaged
def read_mp4(data: bytes, path) -> Track:
    """The first video track of an ISO BMFF file (``.mp4``, ``.mov``)."""
    top = _children(data, 0, len(data), path)
    if b"moov" not in top:
        raise ValueError(f"{path}: no moov box")
    moov = _children(data, *top[b"moov"][0], path)
    ma, _ = moov[b"mvhd"][0]
    mvhd = _matrix(data, ma + (48 if data[ma] == 1 else 36))
    scale_at = ma + (20 if data[ma] == 1 else 12)
    (movie_scale,) = struct.unpack(">I", data[scale_at:scale_at + 4])
    for trak in moov.get(b"trak", []):
        track = _mp4_track(data, trak, path, mvhd, movie_scale)
        if track is not None:
            return track
    raise ValueError(f"{path}: no video track")


# --- RIFF AVI ---------------------------------------------------------------


def _riff(data: bytes, start: int, end: int, path):
    at = start
    while at + 8 <= end:
        fourcc, size = struct.unpack("<4sI", data[at:at + 8])
        if at + 8 + size > end:
            raise ValueError(f"{path}: AVI chunk {fourcc!r} at byte {at} is cut short")
        yield fourcc, at, at + 8 + size
        at += 8 + size + (size & 1)


@_damaged
def read_avi(data: bytes, path) -> Track:
    """The first video stream of a RIFF AVI file, through its ``idx1``."""
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    hdrl = movi = idx1 = None
    for fourcc, a, b in _riff(data, 12, len(data), path):
        if fourcc == b"LIST" and data[a + 8:a + 12] == b"hdrl":
            hdrl = (a + 12, b)
        elif fourcc == b"LIST" and data[a + 8:a + 12] == b"movi":
            movi = (a + 8, b)  # idx1 offsets count from the list's "movi"
        elif fourcc == b"idx1":
            idx1 = (a + 8, b)
    if hdrl is None or movi is None:
        raise ValueError(f"{path}: an AVI file without hdrl or movi")
    if idx1 is None:
        raise _unsupported(f"{path}: an AVI file without idx1 (OpenDML or no index)")
    stream = None
    n_stream = -1
    for fourcc, a, b in _riff(data, *hdrl, path):
        if fourcc != b"LIST" or data[a + 8:a + 12] != b"strl":
            continue
        n_stream += 1
        kids = {k: (x + 8, y) for k, x, y in _riff(data, a + 12, b, path)}
        if b"strh" not in kids or data[kids[b"strh"][0]:kids[b"strh"][0] + 4] != b"vids":
            continue
        stream = n_stream, kids
        break
    if stream is None:
        raise ValueError(f"{path}: no video stream")
    n_stream, kids = stream
    sa, _ = kids[b"strh"]
    scale, rate = struct.unpack("<II", data[sa + 20:sa + 28])
    (length,) = struct.unpack("<I", data[sa + 32:sa + 36])
    fa, _ = kids[b"strf"]
    width, height = struct.unpack("<ii", data[fa + 4:fa + 12])
    compression = bytes(data[fa + 16:fa + 20])
    codec = ("mpeg4" if compression.upper() in AVI_MPEG4_FOURCCS
             else "h264" if compression.upper() in AVI_H264_FOURCCS
             else "hevc" if compression.upper() in AVI_HEVC_FOURCCS
             else "mjpeg" if compression.upper() in AVI_MJPEG_FOURCCS else None)
    if compression.upper() in AVI_MJPEG_REFUSED:
        raise _unsupported(f"{path}: Motion-JPEG of AVI fourcc {compression.decode()!r}",
                           MJPEG_ITEM)
    if codec is None:
        raise _unsupported(f"{path}: AVI video of fourcc "
                           f"{compression.decode(errors='replace')!r}")
    if scale == 0 or rate == 0:
        raise ValueError(f"{path}: AVI stream rate {rate}/{scale}")
    ia, ib = idx1
    rows = np.frombuffer(data, dtype="<u4", count=(ib - ia) // 16 * 4, offset=ia).reshape(-1, 4)
    ids = rows[:, 0].astype("<u4").tobytes()
    tags = [ids[4 * i:4 * i + 4] for i in range(len(rows))]
    want = f"{n_stream:02d}".encode()
    keep = np.array([t[:2] == want and t[2:] in (b"dc", b"db") for t in tags], bool)
    rows = rows[keep].astype(np.int64)
    if len(rows) and data[movi[0] + rows[0, 2]:movi[0] + rows[0, 2] + 2] != want:
        base = 0  # absolute offsets
    else:
        base = movi[0]
    offsets = base + rows[:, 2] + 8
    sizes = rows[:, 3]
    if np.any(offsets + sizes > len(data)):
        raise ValueError(f"{path}: idx1 names a chunk past the end of the file")
    if len(rows) != length:
        raise _unsupported(f"{path}: an AVI stream of {length} frames indexed as {len(rows)}")
    # FFmpeg's demuxer indexes no empty chunk: a seek never lands on one
    sync = ((rows[:, 1] & 0x10) != 0) & (sizes > 0)
    return Track(b"", offsets, sizes, sync, rate / scale, int(length), codec,
                 width=max(width, 0), height=max(height, 0))


def read_track(path) -> tuple:
    """(the file, memory-mapped, and its video ``Track``); the container by
    its first bytes.  A long video is paged in as its samples are read."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path}: an empty file")
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    if data[:4] == b"RIFF":
        return data, read_avi(data, path)
    return data, read_mp4(data, path)



class MP4Dataset(MonocularDataset):
    """Video ingest (``.mp4``, ``.mov``, ``.avi``) through the host library's
    MPEG-4 Part 2, H.264, HEVC and Motion-JPEG decoders, frame for frame as
    cv2 5.0.0 reads it,
    each frame turned by the track's display matrix as cv2 turns it.

    A read at the next frame takes the next frame libavcodec outputs (a
    not-coded VOP or an empty Motion-JPEG chunk outputs none, so cv2's
    frames then run ahead of the samples; H.264 and HEVC pictures come out in display order, the held
    ones drained at the end).  A read elsewhere seeks as ``cv2.VideoCapture.set(
    CAP_PROP_POS_FRAMES, t)`` does (``CvCapture_FFMPEG::seek``; before a
    first seek cv2 reads a frame): it restarts at the last sync sample
    decoded at or before frame ``t - 16``'s time (further back while the
    first frame output lies past ``t - 1``), takes the first frame output
    as the frame its presentation time names, and counts each later output
    as one frame on."""

    def __init__(self, dataset_path, stride: int = 1):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        self._data, self.track = read_track(self.dataset_path)
        track = self.track
        config = track.config
        if not config and len(track.sizes) and track.codec != "mjpeg":
            # AVI: the headers open the first sample
            first = self._sample(0)
            config = first if track.codec in ("h264", "hevc") else \
                first[:first.find(VOP_START)] if VOP_START in first else b""
        self._config = config
        if track.codec in ("h264", "hevc"):
            self._nal_decoder = native.HevcDecoder if track.codec == "hevc" else native.H264Decoder
            self._check_sync_samples(config)
            self._decoder = self._nal_decoder(config, track.length_size)
            self._decoder.delay(self._probe_delay())
            missing = f"no {'HEVC' if track.codec == 'hevc' else 'H.264'} sequence parameter set " \
                "before the first sample"
        elif track.codec == "mjpeg":
            if len(track.sizes) and not track.sizes[0]:
                # cv2 then seeks to no frame and reads on from where it was
                raise _unsupported(f"{self.dataset_path}: a Motion-JPEG track whose first "
                                   "sample is empty", MJPEG_ITEM)
            self._decoder = native.MjpegDecoder(track.width, track.height)
            missing = None
        else:
            self._decoder = native.Mpeg4Decoder(config)
            missing = "no MPEG-4 VOL header before the first VOP"
        if missing and self._decoder.size() is None:
            raise ValueError(f"{self.dataset_path}: {missing}")
        self._cursor = 0  # the next sample to decode
        self._draining = False  # the samples are all fed: held pictures come out
        self._grabbed = False  # a frame was read (cv2 reads one before a first seek)
        # H.264 and HEVC frames decoded ahead of the reader: (frame number, sample fed
        # last when it came out, RGB, whether it is H264Decoder.stale)
        self._ahead = collections.deque()
        self._fault = None  # an error met decoding ahead, raised at the read that reaches it
        self._stale = False  # the frame read last was decoded under sets it was not encoded under
        self._reached = 0  # the samples before it were fed or their parameter sets read
        self._first_out = None  # the frame number of the file's first frame out
        self.fps = track.fps
        self.total_frames = track.frame_count
        self.stride = stride
        self._next_decode = 0
        self.timestamps = [str(i * stride / self.fps) for i in range(len(self))]

    def _check_sync_samples(self, config: bytes) -> None:
        """Each H.264 sync sample must hold an IDR picture, each HEVC one an
        IRAP picture (IDR, CRA or BLA: a seek to a CRA or BLA picture leaves
        its RASL pictures out, as cv2's does): cv2 would drop pictures after
        a seek to another; and the sequence parameter sets they carry must
        agree on the colour (cv2 converts frames around a change otherwise
        than they say)."""
        probe = self._nal_decoder(config, self.track.length_size)
        kind = "an IRAP" if self.track.codec == "hevc" else "an IDR"
        try:
            for i in np.flatnonzero(self.track.sync):
                if not probe.headers(self._sample(int(i))):
                    raise _unsupported(f"{self.dataset_path}: sync sample {int(i)}, not {kind} "
                                       "picture")
        finally:
            probe.close()

    def _probe_delay(self) -> int:
        """The output delay (``has_b_frames``) cv2's decoder starts with:
        what ``avformat_find_stream_info`` leaves.  For ISO BMFF it stops
        once the first sample gives the codec's parameters: FFmpeg's guess
        from the composition offsets (``mov_guess_video_delay``).  For AVI
        it reads on (a frame rate to analyse) and decodes until 7 frames
        come out (18, 20 for delays of 3, 4 or more; none once the delay
        equals num_reorder_frames), the delay growing as libavcodec grows
        it."""
        if self.track.frames is not None or self.track.codec == "hevc":
            # HEVC's output follows its SPS, not this delay, in AVI as in ISO BMFF
            return self.track.video_delay
        probe = native.H264Decoder(self._config, self.track.length_size)
        try:
            probe.delay(self.track.video_delay)
            shown, n = 0, len(self.track.sizes)
            for i in range(n):
                delay, reorder, _ = probe.delay()
                if (delay and reorder == delay) or shown >= (7 if delay < 3 else 18 if delay < 4
                                                             else 20):
                    break
                out = probe.decode(self._sample(i), i)
                shown += out is not None and self._frame(out) >= 0
            return probe.delay()[0]
        except (ValueError, NotImplementedError):
            return self.track.video_delay  # the reads meet the fault themselves
        finally:
            probe.close()

    def _frame(self, sample: int) -> int:
        """The frame number cv2 gives a sample's picture, -1 if not shown."""
        frames = self.track.frames
        return sample if frames is None else int(frames[sample])

    def __len__(self):
        return self.total_frames // self.stride

    def subsample(self, stride: int):
        self.stride *= stride
        self.timestamps = [str(i * self.stride / self.fps) for i in range(len(self))]

    def _sample(self, i: int) -> bytes:
        a = int(self.track.offsets[i])
        return self._data[a:a + int(self.track.sizes[i])]

    def _advance(self) -> Optional[int]:
        """Decode up to the next frame output; its frame number, or None at
        the end (where the pictures held back come out first, as cv2 drains
        the decoder at the end of the file).  Pictures outside the edit are
        decoded and dropped, as FFmpeg drops them."""
        self._grabbed = True
        if self.track.codec not in ("h264", "hevc"):
            while self._cursor < len(self.track.sizes):
                i = self._cursor
                self._cursor += 1
                if self._decoder.decode(self._sample(i)) and self._frame(i) >= 0:
                    self._rgb = self._decoder.rgb()
                    return self._frame(i)
            return None
        # cv2 runs libavcodec with a frame thread a CPU: a frame comes back
        # once FRAME_THREADS - 1 more samples went in, whose pictures count
        # in the output delay that a seek's flush keeps (H.264; HEVC's the
        # same way)
        if not self._ahead and self._fault is not None:
            fault, self._fault = self._fault, None
            raise fault
        while not self._ahead and self._feed():
            pass
        if not self._ahead:
            return None
        frame, fed, self._rgb, self._stale = self._ahead.popleft()
        try:
            while self._cursor < min(fed + FRAME_THREADS - 1, len(self.track.sizes)):
                self._feed()
        except (ValueError, NotImplementedError) as e:
            self._fault = e
        return frame

    def _feed(self) -> bool:
        """Feed the next sample (at the end, drain a held picture) and keep
        the frame that comes out, if shown; False when nothing is left.

        Its frame number is what cv2's seek reads: its presentation time
        (ISO BMFF), or, in AVI, which has none, the sample that let it out
        (FFmpeg stamps a frame with that packet's decode time; a frame
        drained at the end has no time: -1, and cv2's seek then steps
        further back), either counted from the file's first frame out (a
        stream opening with a CRA picture shows none of its RASL
        pictures)."""
        i = None
        if self._cursor < len(self.track.sizes):
            i = self._cursor
            self._cursor += 1
            shown = self._decoder.decode(self._sample(i), i)
        elif not self._draining:
            shown = self._decoder.drain()
            self._draining = shown is None
        else:
            return False
        if shown is None or self._frame(shown) < 0:
            return True
        frame = self._frame(shown) if self.track.frames is not None else -1 if i is None else i
        if self._first_out is None:
            self._first_out = max(frame, 0)
        if frame >= 0:
            frame -= self._first_out
        stale = self.track.codec == "h264" and self._decoder.stale()
        self._ahead.append((frame, self._cursor, self._decoder.rgb(), stale))
        return True

    def _seek_sample(self, frame: int) -> int:
        """The sample ``av_seek_frame`` backward to frame ``frame`` restarts
        at: the last sync sample at or before it (AVI), or decoded at or
        before its time as FFmpeg's mov_seek_stream finds it, the target
        moved by ``Track.seek_offset`` (an HEVC key sample presented after
        the target is taken all the same: cv2's libavformat passes none)."""
        sync = np.flatnonzero(self.track.sync)
        times = self.track.decode_times
        at = sync if times is None else times[sync]
        before = sync[at <= frame + self.track.seek_offset]
        return int(before[-1]) if len(before) else 0

    def _restart(self, frame: int) -> None:
        """Position at the sample a backward seek to frame ``frame`` takes
        (``_seek_sample``), decoder flushed."""
        cursor = self._seek_sample(frame)
        self._reached = max(self._reached, self._cursor)
        if self.track.codec == "h264":
            for i in range(self._reached, cursor):  # the parameter sets of samples skipped
                self._decoder.expect(self._sample(i), i)
        self._reached = max(self._reached, cursor)
        self._cursor = cursor
        self._draining = False
        self._ahead.clear()
        self._fault = None
        self._decoder.reset()

    def _seek(self, t: int) -> None:
        if not self._grabbed and self.total_frames > 1:
            self._advance()  # cv2 grabs a frame before its first seek
        t = min(t, self.total_frames)
        delta = 16
        while True:
            temp = max(t - delta, 0)
            self._restart(temp)
            if t == 0:
                return
            first = self._advance()
            if t == 1:
                return
            if first is None or first < 0 or first > t - 1:
                if temp == 0:
                    return
                delta = delta * 2 if delta < 16 else delta * 3 // 2
                continue
            for _ in range(t - 1 - first):
                if self._advance() is None:
                    break
            return

    def read_img(self, idx):
        target = idx * self.stride
        if target != self._next_decode:
            self._seek(target)
        shown = self._advance()
        self._next_decode = target + 1
        if shown is None:
            raise ValueError(f"failed to decode frame {target}")
        if self._stale:
            raise _unsupported(f"{self.dataset_path}: frame {target}, decoded after a seek under "
                               "H.264 parameter sets it was not encoded under (ROADMAP Queue 3 "
                               "item 28)")
        img = self._rgb
        if self.track.rotation:  # cv2.rotate: 90 clockwise is np.rot90's k = -1
            img = np.ascontiguousarray(np.rot90(img, -self.track.rotation // 90))
        return img

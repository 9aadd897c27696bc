"""Motion-JPEG video input without cv2: the port's ``data/video.MP4Dataset``
(the container walked in Python, each picture decoded by the host
library, ``csrc/host/mjpeg.cpp``) against the JAX package's ``MP4Dataset``
(``cv2.VideoCapture``, cv2 5.0.0), on files that real encoders write:
OpenCV's own MJPEG writer, FFmpeg's (``.avi``, ``.mov`` with ``jpeg``,
``.mp4`` with ``mp4v`` of objectTypeIndication 0x6C) and libjpeg-turbo's
pictures (``cv2.imencode``) in AVIs written here, and on pictures of
random coefficients (``tests/torch_mjpeg_files.py``: 16-bit DQTs, every
Huffman symbol, restart intervals, one scan a component, coefficients that
saturate the IDCT).  Every frame must be exactly cv2's, sequentially,
after forward and backward seeks and after ``subsample(4)``, with the same
``len``, ``fps`` and timestamps, and libavcodec must log no error while
cv2 reads.  What the decoder does not take raises ``NotImplementedError``
naming ROADMAP Queue 1 item 17f, damaged data ``ValueError``.  The
committed fixtures of ``chip_smoke.py`` phase 25 must still be cv2's.
"""

import hashlib
import json
import pathlib
import struct

import cv2
import numpy as np
import pytest

from mast3r_slam_tpu.data.dataloader import MP4Dataset as JaxMP4Dataset
from mast3r_slam_tpu_torch.data import video
from mast3r_slam_tpu_torch.utils import native

import torch_jpeg_encoders as je
import torch_mjpeg_files as mf
import torch_video_files as vf

DATA = pathlib.Path(__file__).resolve().parent / "data"
DIGESTS = json.loads((DATA / "mjpeg_fixtures.json").read_text())
ITEM = "item 17f"


def _digest(img):
    return None if img is None else hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _reads(ds, order):
    out = []
    for i in order:
        try:
            out.append(ds.read_img(i))
        except ValueError:
            out.append(None)
    return out


def _same_reads(path, order, capfd, stride=1):
    want, got = JaxMP4Dataset(path), video.MP4Dataset(path)
    if stride > 1:
        want.subsample(stride)
        got.subsample(stride)
    assert len(got) == len(want) and got.fps == want.fps
    assert got.timestamps == want.timestamps
    for i, a, b in zip(order, _reads(got, order), _reads(want, order)):
        if b is None:
            assert a is None, f"frame {i}: cv2's read fails, the port's gives a frame"
            continue
        assert a is not None, f"frame {i}: the port's read fails"
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"{path.name} frame {i}")
    log = capfd.readouterr().err
    assert "[mjpeg" not in log, log  # libavcodec logs at cv2's level (errors) nothing


def _all_reads(path, capfd, n):
    _same_reads(path, range(n), capfd)
    _same_reads(path, [n - 1, 0, n // 2, 1, n // 2 + 1, 2, n - 2, n], capfd)
    _same_reads(path, range(len(range(0, n, 4))), capfd, stride=4)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_mjpeg_fixtures_agree_with_cv2(name):
    """The files ``chip_smoke.py`` phase 25 decodes on the card's host (no cv2
    there; ``scripts/make_mjpeg_fixtures.py`` wrote them): their committed
    digests are still what the JAX package's dataset gives here, and the
    port's dataset gives those bytes."""
    want = DIGESTS[name]
    path = DATA / name
    jax = JaxMP4Dataset(path)
    assert [jax.total_frames, jax.fps] == [want["frame_count"], want["fps"]]
    assert [_digest(f) for f in _reads(jax, range(len(jax)))] == want["frames"]
    ds = video.MP4Dataset(path)
    assert ds.track.codec == "mjpeg"
    assert [ds.total_frames, ds.fps] == [want["frame_count"], want["fps"]]
    assert [_digest(f) for f in _reads(ds, range(len(ds)))] == want["frames"]
    assert list(video.MP4Dataset(path).read_img(0).shape) == want["shape"]
    order = [t for t, _ in want["seeks"]]
    assert [_digest(f) for f in _reads(video.MP4Dataset(path), order)] == \
        [d for _, d in want["seeks"]]
    sub = video.MP4Dataset(path)
    sub.subsample(4)
    assert [_digest(f) for f in _reads(sub, range(len(sub)))] == want["subsample4"]


# (suffix, writer) of cv2.VideoWriter's two MJPEG encoders
WRITERS = {"opencv-avi": (".avi", "opencv"), "ffmpeg-avi": (".avi", "ffmpeg"),
           "ffmpeg-mov": (".mov", "ffmpeg"), "ffmpeg-mp4": (".mp4", "ffmpeg")}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_files_cv2_writes_read_as_cv2_reads_them(tmp_path, capfd, writer):
    """OpenCV's and FFmpeg's MJPEG writers at a size that is no multiple of
    the MCU, in each container they write."""
    suffix, api = WRITERS[writer]
    path = tmp_path / f"clip{suffix}"
    mf.write_cv2(path, vf.frames("tex", 72, 34, 9, 20, 2), 24.0, api=api)
    assert video.MP4Dataset(path).track.codec == "mjpeg"
    _all_reads(path, capfd, 9)


@pytest.mark.parametrize("seed", range(6))
def test_libjpeg_turbo_pictures_read_as_cv2_reads_them(tmp_path, capfd, seed):
    """A sweep of what cv2.imencode writes: qualities (DQT), restart
    intervals (DRI), 4:2:0, 4:2:2 and gray, sizes that are no multiple of
    the MCU, in AVI, MOV (``jpeg``) and MP4 (``mp4v``)."""
    rng = np.random.default_rng(seed)
    sampling = ["420", "422", "gray"][seed % 3]
    w, h = int(rng.integers(8, 80)), 2 * int(rng.integers(4, 30)) + (sampling == "gray")
    frames = vf.frames(["tex", "smooth", "waves"][seed % 3], w, h, 6, seed, 3)
    pics = [mf.imencode(f if sampling != "gray" else f[..., 1], sampling,
                        int(rng.integers(5, 101)), int(rng.integers(0, 4))) for f in frames]
    suffix = [".avi", ".mov", ".mp4"][seed // 2 % 3]
    path = tmp_path / f"clip{suffix}"
    if suffix == ".avi":
        mf.write_avi(path, pics, w, h, fps=25)
    else:
        mf.write_mp4(path, pics, w, h, fourcc=b"mp4v" if suffix == ".mp4" else b"jpeg",
                     brand=b"isom" if suffix == ".mp4" else b"qt  ")
    _all_reads(path, capfd, 6)


@pytest.mark.parametrize("seed", range(6))
def test_random_coefficients_read_as_cv2_reads_them(tmp_path, capfd, seed):
    """Pictures of random coefficients through every Huffman symbol, 8- and
    16-bit DQTs (dequantised values past 16 bits wrap; row sums past 16
    bits saturate in the SSE2 IDCT), restart intervals and one scan a
    component: the IDCT, its coefficient order and the scans as libavcodec
    runs them."""
    rng = np.random.default_rng(100 + seed)
    sampling = ["420", "422", "gray"][seed % 3]
    w, h = int(rng.integers(1, 70)), 2 * int(rng.integers(1, 24))
    pics = [mf.random_picture(rng, w, h, sampling, tables="full", wide=seed >= 3,
                              spread=[4.0, 60.0, 600.0][seed % 3],
                              restart=int(rng.integers(0, 5)), separate=bool(seed % 2))
            for _ in range(4)]
    path = tmp_path / "clip.avi"
    mf.write_avi(path, pics, w, h)
    _all_reads(path, capfd, 4)


def test_the_yuvj_conversions_hold_across_the_range(tmp_path, capfd):
    """A picture of 512x256 pixels whose coefficients swing every sample
    past its range: libswscale's yuvj420p and yuvj422p conversions (and
    gray) on as many (Y, U, V) as the picture holds, clipping included."""
    rng = np.random.default_rng(7)
    for sampling in ("420", "422", "gray"):
        pics = [mf.random_picture(rng, 512, 256, sampling, tables="full", spread=300.0)]
        path = tmp_path / f"{sampling}.avi"
        mf.write_avi(path, pics, 512, 256)
        _same_reads(path, [0], capfd)


def test_a_frame_without_dht_reads_as_the_frame_with_it(tmp_path, capfd):
    """UVC cameras leave the DHT out (an AVI1 APP0 instead): libavcodec then
    decodes with its default tables, the standard ones libjpeg-turbo codes
    with."""
    frames = vf.frames("waves", 64, 48, 4, 1, 2)
    pics = [mf.imencode(f, "422", 90) for f in frames]
    bare = [mf.with_segments(mf.strip_dht(p), [(0xE0, mf.AVI1)]) for p in pics]
    assert all(b"\xff\xc4" not in p for p in bare)
    mf.write_avi(tmp_path / "dht.avi", pics, 64, 48)
    mf.write_avi(tmp_path / "bare.avi", bare, 64, 48)
    _all_reads(tmp_path / "bare.avi", capfd, 4)
    a, b = video.MP4Dataset(tmp_path / "dht.avi"), video.MP4Dataset(tmp_path / "bare.avi")
    for i in range(4):
        np.testing.assert_array_equal(a.read_img(i), b.read_img(i))


def test_tables_carry_over_to_later_samples_and_seeks(tmp_path, capfd):
    """libavcodec keeps a sample's DQT and DHT for the samples after it, and
    across a seek (the tables of the last sample decoded): pictures 1-5
    hold neither, so a seek's first read takes the tables read last."""
    rng = np.random.default_rng(3)
    pics = []
    for k in range(6):
        pic = mf.random_picture(rng, 40, 24, "420", tables="full", wide=k == 0)
        pics.append(pic if k == 0 else _without(pic, (0xC4, 0xDB)))
    pics[3] = mf.random_picture(rng, 40, 24, "420", tables="full")  # new tables
    path = tmp_path / "carry.avi"
    mf.write_avi(path, pics, 40, 24)
    _all_reads(path, capfd, 6)
    _same_reads(path, [4, 1, 5, 0, 3, 2], capfd)


def _without(pic: bytes, markers) -> bytes:
    """``pic`` without its segments of ``markers`` (before the first scan)."""
    out, at = bytearray(pic[:2]), 2
    while pic[at + 1] != 0xDA:
        length = struct.unpack(">H", pic[at + 2:at + 4])[0]
        if pic[at + 1] not in markers:
            out += pic[at:at + 2 + length]
        at += 2 + length
    return bytes(out + pic[at:])


@pytest.mark.parametrize("where", [[2], [5], [1, 6, 7], [9]])
def test_an_empty_chunk_counts_and_shows_nothing(tmp_path, capfd, where):
    """An empty ``00dc`` chunk (a dropped frame, as capture tools write):
    cv2 counts it in the frame count, decodes nothing for it, so its later
    reads come a frame early and its last reads fail, and a seek never
    lands on it (FFmpeg's demuxer indexes no empty chunk)."""
    pics = [mf.imencode(f, "422", 70) for f in vf.frames("smooth", 48, 32, 10, 4, 2)]
    for k in where:
        pics[k] = b""
    path = tmp_path / "dropped.avi"
    mf.write_avi(path, pics, 48, 32)
    _all_reads(path, capfd, 10)
    _same_reads(path, [5, 2, 9, 3, 8, 1, 7, 4], capfd)


def test_cv2_reads_the_mjpeg_fourccs_the_port_reads(tmp_path):
    """The AVI fourccs that cv2 reads as it reads MJPG (matched upper-cased)
    read as Motion-JPEG; those libavcodec decodes apart are refused."""
    pics = [mf.imencode(f, "420", 80) for f in vf.frames("tex", 32, 16, 2, 5, 2)]
    ref = None
    for fourcc in sorted(video.AVI_MJPEG_FOURCCS) + [b"mjpg", b"jpeg"]:
        path = tmp_path / f"{fourcc.decode()}.avi"
        mf.write_avi(path, pics, 32, 16, fourcc=fourcc)
        ok, frame = cv2.VideoCapture(str(path)).read()
        assert ok, fourcc
        ref = frame if ref is None else ref
        np.testing.assert_array_equal(frame, ref, err_msg=str(fourcc))
        assert video.MP4Dataset(path).track.codec == "mjpeg"
    for fourcc in sorted(video.AVI_MJPEG_REFUSED) + [b"AVRn"]:
        path = tmp_path / f"{fourcc.decode()}.avi"
        mf.write_avi(path, pics, 32, 16, fourcc=fourcc)
        with pytest.raises(NotImplementedError, match=ITEM):
            video.MP4Dataset(path)


def _refused_pictures():
    """name -> (pictures, width, height, container height): what the decoder
    refuses."""
    rng = np.random.default_rng(9)
    bgr = vf.frames("smooth", 32, 16, 2, 2, 2)
    coefs = mf.random_coefs(rng, 32, 16, "420")
    out = {}
    out["progressive"] = [mf.imencode(f, "420", progressive=True) for f in bgr]
    out["arithmetic"] = [je.arithmetic_jpeg(f[..., ::-1], sampling="420") for f in bgr]
    out["lossless"] = [je.lossless_jpeg([f[..., c] for c in range(3)]) for f in bgr]
    out["12-bit"] = [mf.picture(coefs, 32, 16, "420", sof=0xC1, bits=12)] * 2
    out["hierarchical"] = [mf.picture(coefs, 32, 16, "420", sof=0xC5)] * 2
    for sampling in ("444", "440", "411"):
        out[sampling] = [mf.imencode(f, sampling) for f in bgr]
    out["odd-height"] = [mf.imencode(f[:15], "420") for f in bgr]
    out["qfa-components"] = [mf.picture(coefs, 32, 16, "420", ids=[ord(c) for c in "QFA"])] * 2
    out["cs-itu601"] = [mf.with_segments(mf.imencode(f), [(0xFE, b"CS=ITU601")]) for f in bgr]
    out["flipped"] = [mf.with_segments(mf.imencode(f), [
        (0xFE, b"Intel(R) JPEG Library, version 1.5\n")]) for f in bgr]
    out["size-change"] = [mf.imencode(bgr[0]), mf.imencode(bgr[1][:, :16])]
    return {k: (v, 32, 16, 16) for k, v in out.items()} | {
        "avi1-field-pair": ([mf.with_segments(mf.imencode(f), [(0xE0, mf.AVI1)]) for f in bgr],
                            32, 16, 32)}


REFUSED = _refused_pictures()


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_what_is_not_ported_is_refused(tmp_path, what):
    """Progressive, arithmetic, lossless, 12-bit and hierarchical coding, the
    samplings libswscale converts through its scaler (4:4:4, 4:4:0, 4:1:1,
    odd heights), component layouts libavcodec reads otherwise (QFA as
    RGB), the comments it acts on, a size that changes, and an AVI1 field
    pair (a frame under 3/4 of the track's height) raise
    ``NotImplementedError`` naming item 17f; nothing falls back to cv2."""
    pics, w, h, track_h = REFUSED[what]
    path = tmp_path / "refused.avi"
    mf.write_avi(path, pics, w, track_h)
    ds = video.MP4Dataset(path)
    with pytest.raises(NotImplementedError, match=ITEM):
        ds.read_img(0)
        ds.read_img(1)


def test_the_refused_containers_and_a_first_empty_chunk(tmp_path):
    """QuickTime's other Motion-JPEG sample entries (``mjpa``, ``mjpb``,
    ``AVDJ``) and an AVI whose first chunk is empty (cv2's seek to frame 0
    then lands on nothing and reads on from where it was) are refused."""
    pics = [mf.imencode(f) for f in vf.frames("tex", 32, 16, 3, 5, 2)]
    for entry in (b"mjpa", b"mjpb", b"AVDJ"):
        path = tmp_path / f"{entry.decode()}.mov"
        mf.write_mp4(path, pics, 32, 16, fourcc=entry)
        with pytest.raises(NotImplementedError, match=ITEM):
            video.MP4Dataset(path)
    path = tmp_path / "first.avi"
    mf.write_avi(path, [b""] + pics[1:], 32, 16)
    with pytest.raises(NotImplementedError, match=ITEM):
        video.MP4Dataset(path)


def _damaged():
    rng = np.random.default_rng(4)
    pic = mf.imencode(vf.frames("tex", 32, 16, 1, 3, 2)[0], "420", 90, restart=1)
    scan = pic.index(b"\xff\xda") + 14
    out = {"truncated": pic[:scan + 20], "no-scan": pic[:scan - 14] + b"\xff\xd9",
           "restart-marker-gone": pic[:scan] + pic[scan:].replace(b"\xff\xd0", b"", 1)}
    bad = bytearray(mf.picture(mf.random_coefs(rng, 32, 16, "420"), 32, 16, "420"))
    at = bytes(bad).index(b"\xff\xda") + 14
    bad[at:at + 4] = b"\xff\x00\xff\x00"  # sixteen 1 bits: no DC code starts so
    out["bad-code"] = bytes(bad)
    return out


DAMAGED = _damaged()


@pytest.mark.parametrize("what", sorted(DAMAGED))
def test_damaged_pictures_raise_value_error(what):
    dec = native.MjpegDecoder(32, 16)
    with pytest.raises(ValueError):
        dec.decode(DAMAGED[what])
    good = mf.imencode(vf.frames("tex", 32, 16, 1, 3, 2)[0])
    assert dec.decode(good) and dec.rgb().shape == (16, 32, 3)


def test_the_idct_is_the_mpeg4_decoders():
    """One IDCT for both decoders (``csrc/host/idct.h``): MPEG-4 Part 2 no
    longer defines its own."""
    host = pathlib.Path(native.__file__).resolve().parents[1] / "csrc" / "host"
    for name in ("mpeg4.cpp", "mjpeg.cpp"):
        src = (host / name).read_text()
        assert '#include "idct.h"' in src and "void idct_row" not in src, name

"""HEVC Main 10 video input without cv2: the port's ``data/video.MP4Dataset``
(``csrc/host/hevc.cpp`` at 9 and 10 bits, converted as
``csrc/host/swscale.h`` models libswscale's scaler) against the JAX
package's ``MP4Dataset`` (``cv2.VideoCapture``, cv2 5.0.0) on streams
written here (``tests/torch_hevc_files.py``: cv2 decodes HEVC but cannot
encode it).

Random I/P and B syntax (B pyramids with RASL, RADL and BLA pictures) at 9
and 10 bits, one stream a feature the bit depth reaches (QPs below 0 and
cu_qp_delta past 26, SAO offsets up to 31, explicit weights, 16-bit
residuals, vectors far out, intra smoothing, transform skip, deblocking
offsets), the colour cv2 converts by (BT.709, BT.2020 NCL, FCC, SMPTE 240M,
full range, the six chroma sites, a ``colr`` box the VUI overrides), smooth
pans, in ``.mp4`` (``hvc1``, ``hev1``), ``.mov`` and ``.avi``.  Every frame
must be exactly cv2's, sequentially, after forward and backward seeks and
after ``subsample(4)``, with the same ``len``, ``fps`` and timestamps.  The
conversion alone is held to cv2's read of the same planes in a YUV4MPEG
file.  What the port does not take (depths over 10, luma and chroma of
different depths, BT.2020 primaries, a depth that changes) raises
``NotImplementedError`` naming ROADMAP Queue 1 item 17.  The committed
fixtures of ``chip_smoke.py`` phase 26 must still be cv2's.
"""

import hashlib
import json
import pathlib

import cv2
import numpy as np
import pytest

from mast3r_slam_tpu.data.dataloader import MP4Dataset as JaxMP4Dataset
from mast3r_slam_tpu_torch.data import video
from mast3r_slam_tpu_torch.utils import native

import torch_hevc_files as hv

DATA = pathlib.Path(__file__).resolve().parent / "data"
DIGESTS = json.loads((DATA / "hevc10_fixtures.json").read_text())
N = 10  # pictures a stream
# libavcodec's own error for each slice after the first of a RASL picture
# it leaves out (tests/test_torch_hevc_b.py)
SKIPPED_SLICE = "PPS changed between slices."


def _write(path, samples, o, w, h, suffix, k=0, colr=None):
    """``samples`` into ``path`` + ``suffix``: ISO BMFF (``hvc1``, or
    ``hev1`` with the parameter sets in band, by ``k``; a B stream behind
    FFmpeg's ``ctts`` and edit) or Annex B in AVI."""
    path = path.with_suffix(suffix)
    if suffix == ".avi":
        hv.write_avi(path, samples, w, h, fourcc=[b"HEVC", b"H265"][k % 2])
    else:
        hv.write_mp4(path, samples, w, h, fps=[30, 25][k % 2], display=o.get("display"),
                     fourcc=b"hev1" if k % 2 else b"hvc1", config_in_band=bool(k % 2),
                     brand=b"qt  " if suffix == ".mov" else b"isom", colr=colr)
    return path


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
    shown = 0
    for i, a, b in zip(order, _reads(got, order), _reads(want, order)):
        if b is None:
            assert a is None, f"frame {i}: cv2's read fails, the port's gives a frame"
            continue
        assert a is not None, f"frame {i}: the port's read fails"
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"{path.name} frame {i}")
        shown += 1
    log = [line for line in capfd.readouterr().err.splitlines()
           if "[hevc" in line and SKIPPED_SLICE not in line]
    assert not log, log  # libavcodec logs at cv2's level (errors) nothing
    return shown


def _all_reads(path, capfd, n=N):
    assert _same_reads(path, range(n), capfd) > 0
    _same_reads(path, [n - 1, 0, n // 2, 1, n // 2 + 1, 2, n - 2, 7 % n, 6 % n], capfd)
    _same_reads(path, range(len(range(0, n, 4))), capfd, stride=4)


@pytest.mark.parametrize("seed", range(6))
def test_random_syntax_at_9_and_10_bits_reads_as_cv2_reads_it(tmp_path, capfd, seed):
    """I and P pictures, every tool drawn from the seed."""
    w, h = [(64, 48), (48, 32), (56, 40)][seed % 3]
    depth = 10 if seed < 4 else 9
    samples, o = hv.random_stream(w, h, N, 500 + seed, gop=[5, 4, 10][seed % 3], bit_depth=depth)
    path = _write(tmp_path / f"random{seed}", samples, o, w, h,
                  [".mp4", ".mov", ".avi", ".mp4"][seed % 4], seed)
    _all_reads(path, capfd)


@pytest.mark.parametrize("seed", range(4))
def test_random_b_syntax_at_9_and_10_bits_reads_as_cv2_reads_it(tmp_path, capfd, seed):
    """B pyramids, each IRAP picture of any style (RASL, RADL, BLA)."""
    w, h = [(64, 48), (48, 32)][seed % 2]
    samples, o = hv.random_stream(w, h, 12, 600 + seed, gop=[6, 4][seed % 2],
                                  bframes=[3, 2][seed % 2], styles=tuple(hv.IRAP_STYLES),
                                  slices=1, bit_depth=10 if seed < 3 else 9)
    path = _write(tmp_path / f"b{seed}", samples, o, w, h, [".mp4", ".avi", ".mov", ".mp4"][seed],
                  seed // 2)
    _all_reads(path, capfd, 12)


# name -> (width, height, container, random_stream options), 10 bits unless set
FEATURES = {
    "negative-qps-and-cu-qp-delta": (64, 48, ".mp4", dict(
        log2_ctb=5, pps=dict(cu_qp_delta=True, qg_depth=2, init_qp=-10, cqp=[-12, 12],
                             slice_cqp=True))),
    "sao-offsets-to-31": (64, 48, ".mov", dict(sao=True, slices=2)),
    "sao-offsets-to-15-at-9-bits": (48, 32, ".avi", dict(sao=True, bit_depth=9)),
    "weighted-prediction": (48, 32, ".mp4", dict(max_ref=3, pps=dict(weighted=True))),
    "explicit-bi-prediction-weights": (48, 32, ".mov", dict(
        bframes=3, max_ref=3, dirs=[hv.PRED_BI, hv.PRED_L0, hv.PRED_L1],
        pps=dict(weighted=True, weighted_bipred=True))),
    "levels-of-16-bits": (32, 16, ".mp4", dict(big=0.5)),
    "levels-of-16-bits-at-9-bits": (32, 16, ".avi", dict(big=0.5, bit_depth=9)),
    "vectors-far-out": (32, 16, ".avi", dict(far_mv=True, mvd=64)),
    "bi-prediction-far-out": (32, 16, ".mp4", dict(bframes=2, far_mv=True, mvd=64,
                                                   dirs=[hv.PRED_BI])),
    "strong-intra-smoothing": (96, 64, ".mov", dict(strong=True, log2_ctb=5, p_intra=0.5)),
    # a stream whose 32x32 intra edges fall between 8 and 32 from flat: the
    # threshold 1 << (BitDepth - 5) decides them
    "strong-intra-smoothing-threshold": (96, 64, ".mp4", dict(
        strong=True, log2_ctb=5, p_intra=1.0, big=0.0, pps=dict(init_qp=0), seed=902, n=4,
        gop=4)),
    "transform-skip-and-sign-hiding": (48, 32, ".mp4", dict(pps=dict(ts=True, sdh=True))),
    "deblocking-offsets": (64, 48, ".avi", dict(slices=3, pps=dict(
        dbk_ctrl=(True, False, 3, -4), lf_across=True))),
    "constrained-intra": (64, 48, ".mp4", dict(p_intra=0.5, pps=dict(cip=True))),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_each_feature_at_the_depth_reads_as_cv2_reads_it(tmp_path, capfd, name):
    w, h, suffix, kw = FEATURES[name]
    kw = dict(kw)
    kw.setdefault("bit_depth", 10)
    if kw.get("bframes"):
        kw.update(styles=("idr", "cra-rasl"), slices=1)
    k = sorted(FEATURES).index(name)
    n = kw.pop("n", N)
    samples, o = hv.random_stream(w, h, n, kw.pop("seed", 700 + k), gop=kw.pop("gop", 5), **kw)
    path = _write(tmp_path / name, samples, o, w, h, suffix, k)
    _all_reads(path, capfd, n)


@pytest.mark.parametrize("depth", [8, 9, 10])
def test_sums_past_16_bits_read_as_cv2_reads_them(tmp_path, capfd, depth):
    """``hv.extreme_stream``: a half-sample prediction past 16 bits before
    its shift, bi-predicted with one far below zero (libavcodec's SIMD code
    saturates the first at 8 and 10 bits, its C code wraps it at 9 where it
    stores list 0's), and a residual that saturates 16 bits beside the
    largest prediction (its 10-bit SIMD add wraps the sum)."""
    samples, o = hv.extreme_stream(64, 64, depth)
    path = _write(tmp_path / "extreme", samples, o, 64, 64, ".mp4")
    assert _same_reads(path, range(2), capfd) == 2
    _same_reads(path, [1, 0], capfd)


# name -> (VUI, colr box): cv2 converts by the VUI's matrix, range and
# chroma site; an ISO BMFF colr box does not override them
COLOURS = {
    "bt709": (dict(prim=1, trc=1, matrix=1), None),
    "bt2020-ncl": (dict(prim=1, trc=14, matrix=9), None),
    "bt2020-ncl-full-range": (dict(prim=2, trc=2, matrix=9, full_range=True), None),
    "fcc": (dict(matrix=4), None),
    "smpte-240m-full-range": (dict(matrix=7, prim=7, trc=7, full_range=True), None),
    "bt601-full-range": (dict(matrix=6, full_range=True), None),
    "colr-box-under-the-vui": (dict(prim=1, trc=1, matrix=1), (9, 16, 9, 1)),
    "colr-box-without-vui-colour": (None, (1, 1, 1, 1)),
}
COLOURS.update({f"chroma-site-{t}": (dict(matrix=1, chroma_loc=(t, t)), None) for t in range(1, 6)})


@pytest.mark.parametrize("name", sorted(COLOURS))
def test_colour_reads_as_cv2_reads_it(tmp_path, capfd, name):
    vui, colr = COLOURS[name]
    k = sorted(COLOURS).index(name)
    samples, o = hv.random_stream(48, 32, 6, 800 + k, gop=3, bit_depth=10 - k % 2, vui=vui)
    path = _write(tmp_path / name, samples, o, 48, 32, ".avi" if colr is None and k % 3 == 0
                  else ".mp4", colr=colr)
    _same_reads(path, range(6), capfd)
    _same_reads(path, [5, 1, 3], capfd)


@pytest.mark.parametrize("size,depth", [((64, 48), 10), ((48, 32), 9), ((200, 104), 10)])
def test_a_smooth_pan_reads_as_cv2_reads_it(tmp_path, capfd, size, depth):
    """The encoder of real content (``smooth_stream``) from planes of the
    depth, as the CLI clip is made; with B pictures at the first size."""
    w, h = size
    kw = dict(gop=4, bframes=3) if w == 64 else {}
    samples, o = hv.smooth_stream(w, h, 6, 7, step=4, bit_depth=depth, **kw)
    path = tmp_path / "pan.mp4"
    hv.write_mp4(path, samples, w, h, display=o.get("display"))
    _same_reads(path, range(6), capfd)
    _same_reads(path, [5, 0, 3], capfd)


def _y4m(path, planes, depth):
    """A YUV4MPEG2 file of one frame of 4:2:0 ``planes`` at ``depth`` bits
    (little-endian 16-bit samples): cv2 reads it through the same libswscale
    call, the chroma site unstated (centred)."""
    h, w = planes[0].shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420p{depth}\nFRAME\n".encode())
        for p in planes:
            f.write(p.astype("<u2").tobytes())


@pytest.mark.parametrize("depth", [9, 10])
def test_the_scaled_conversion_equals_cv2s(tmp_path, depth):
    """``swscale.h`` (through the host library's ``yuv420_high_rgb``) against
    cv2's read of the same planes: random samples at heights where the
    chroma filter takes 1, 2 and 4 taps, and the extremes of every sample."""
    rng = np.random.default_rng(depth)
    lib = native.load()
    top = (1 << depth) - 1
    for h, w in [(2, 2), (4, 6), (8, 8), (10, 14), (16, 40), (50, 64)]:
        planes = [rng.integers(0, top + 1, (h, w))] + [rng.integers(0, top + 1, (h // 2, w // 2))
                                                        for _ in range(2)]
        if h == 50:  # every extreme
            planes = [np.where(p > top // 2, top, 0) for p in planes]
        _y4m(tmp_path / "f.y4m", planes, depth)
        ok, bgr = cv2.VideoCapture(str(tmp_path / "f.y4m")).read()
        assert ok
        rgb = np.zeros((h, w, 3), np.uint8)
        src = [np.ascontiguousarray(p, np.uint16) for p in planes]
        assert lib.yuv420_high_rgb(*[native._ptr(p, native._U16P) for p in src], w, h, depth,
                                   2, 0, 1, native._ptr(rgb, native._U8P)) == 0
        np.testing.assert_array_equal(rgb, bgr[..., ::-1], err_msg=f"{h}x{w}")


def _digest(img):
    return None if img is None else hashlib.sha256(img.tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_main10_fixtures_agree_with_cv2(name):
    """The committed files are read exactly as cv2 read them when they were
    written (scripts/make_hevc10_fixtures.py)."""
    want = DIGESTS[name]
    path = DATA / name
    ds = video.MP4Dataset(path)
    assert (ds.total_frames, ds.fps) == (want["frame_count"], want["fps"])
    assert [_digest(f) for f in _reads(ds, range(len(ds)))] == want["frames"]
    order = [t for t, _ in want["seeks"]]
    assert [[t, _digest(f)] for t, f in zip(order, _reads(video.MP4Dataset(path), order))] \
        == want["seeks"]
    sub = video.MP4Dataset(path)
    sub.subsample(4)
    assert [_digest(f) for f in _reads(sub, range(len(sub)))] == want["subsample4"]


def _refused(path):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        ds = video.MP4Dataset(path)
        for i in range(len(ds)):
            ds.read_img(i)


@pytest.mark.parametrize("what,kw", [
    ("bit-depth-12", dict(bit_depth=12)),
    ("luma-and-chroma-of-different-depths", dict(bit_depth=10, bit_depth_chroma=9)),
    ("bt2020-primaries", dict(bit_depth=10, vui=dict(prim=9, trc=16, matrix=9))),
])
def test_main10_cases_not_ported_are_refused(tmp_path, capfd, what, kw):
    samples, o = hv.random_stream(32, 16, 3, 9, gop=3, **kw)
    path = _write(tmp_path / "refused", samples, o, 32, 16, ".mp4")
    _refused(path)
    if what == "luma-and-chroma-of-different-depths":  # libavcodec decodes no frame of it
        assert _reads(JaxMP4Dataset(path), range(3)) == [None] * 3
    capfd.readouterr()


def test_a_bit_depth_that_changes_is_refused(tmp_path):
    """An 8-bit stream, then a 10-bit one behind new parameter sets in band."""
    a, _ = hv.random_stream(32, 16, 3, 9, gop=3)
    b, _ = hv.random_stream(32, 16, 3, 10, gop=3, bit_depth=10)
    path = tmp_path / "change.mp4"
    hv.write_mp4(path, a + b, 32, 16, fourcc=b"hev1", config_in_band=True)
    _refused(path)

"""The port's JPEG decoder (``csrc/host/jpeg.cpp`` through
``utils/native.decode_jpeg``) against ``cv2.imdecode`` (libjpeg-turbo),
which the JAX server runs: exact pixels, since the decoder follows
libjpeg's ISLOW IDCT, its fancy upsampling and its fixed-point colour
conversion.  Progressive streams (SOF2) as cv2 writes them, with their
four scan kinds, and scripts cut from them, which libjpeg-turbo smooths
(its block smoothing, ported).  Colour read to gray as ``IMREAD_GRAYSCALE``
reads it (the Y plane, libjpeg's RGB->gray of RGB-coded streams); CMYK and
YCCK streams (PIL writes them) as OpenCV converts them.  Also: the EXIF
orientations as cv2 applies them, and the committed fixture pair that
``chip_smoke.py`` phase 11 checks on the card's host, which has no cv2.

Arithmetic-coded (SOF9, SOF10, DAC) and lossless (SOF3) streams come from
the test-side encoders of ``tests/torch_jpeg_encoders.py`` (neither cv2 nor
PIL writes them) and from seeded random bits, which drive libjpeg's
bad-data paths: the decoder equals cv2 on each, colour and gray reads.
What cv2 returns nothing for (hierarchical coding, SOF11, 12-bit samples,
lossless reads that need a colour conversion) raises ``ValueError``, as
truncated, corrupt or oversized streams do, each beside cv2's ``None``."""

import io
import json
import pathlib
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import torch_jpeg_encoders as enc
from mast3r_slam_tpu_torch.data.png import read_png
from mast3r_slam_tpu_torch.utils import native

DATA = pathlib.Path(__file__).resolve().parent / "data"
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _image(h, w, seed, noise=True):
    rng = np.random.default_rng(seed)
    if noise:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(x / 7.0), 128 + 100 * np.cos(y / 5.0), (3 * x + 2 * y) % 256],
                 -1)
    return np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.uint8)


def _jpeg(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def _cv2_gray(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


def _assert_reads_as_cv2(data):
    """The colour and the gray read both equal cv2's; where cv2 returns
    nothing, the read raises ValueError."""
    for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if want is None:
            with pytest.raises(ValueError):
                native.decode_jpeg(data, gray=gray)
            continue
        if not gray:
            want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(native.decode_jpeg(data, gray=gray), want)


def _assert_cv2_refuses(data, match):
    """cv2 returns nothing for either read, and the decoder raises ValueError."""
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), flag) is None
    for gray in (False, True):
        with pytest.raises(ValueError, match=match):
            native.decode_jpeg(data, gray=gray)


CASES = [(hw, q, s, r, noise)
         for hw in [(48, 64), (37, 53), (120, 160), (1, 1), (3, 2), (9, 17)]
         for q in (50, 90, 100) for s in SAMPLING for r in (0, 2) for noise in (True, False)
         if not (hw in [(1, 1), (3, 2), (9, 17)] and (q != 90 or noise))]


@pytest.mark.parametrize("hw,quality,sampling,restart,noise", CASES,
                         ids=[f"{h}x{w}-q{q}-{s}-rst{r}-{'noise' if n else 'smooth'}"
                              for (h, w), q, s, r, n in CASES])
def test_decode_equals_cv2(hw, quality, sampling, restart, noise):
    data = _jpeg(_image(*hw, seed=hw[0] + quality, noise=noise), cv2.IMWRITE_JPEG_QUALITY,
                 quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                 cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    np.testing.assert_array_equal(native.decode_jpeg(data), _cv2_rgb(data))


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline", "progressive"])
@pytest.mark.parametrize("hw,quality,sampling,restart,noise", CASES,
                         ids=[f"{h}x{w}-q{q}-{s}-rst{r}-{'noise' if n else 'smooth'}"
                              for (h, w), q, s, r, n in CASES])
def test_colour_read_as_gray_equals_cv2(hw, quality, sampling, restart, noise, progressive):
    """``IMREAD_GRAYSCALE`` of a YCbCr stream: libjpeg decodes the Y
    component alone, at full size, without the chroma."""
    data = _jpeg(_image(*hw, seed=hw[0] + quality, noise=noise), cv2.IMWRITE_JPEG_QUALITY,
                 quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                 cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_PROGRESSIVE,
                 progressive)
    got = native.decode_jpeg(data, gray=True)
    assert got.shape == hw and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_gray(data))


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (5, 3)])
def test_gray_decodes_replicated(hw):
    data = _jpeg(_image(*hw, seed=3)[..., 0], cv2.IMWRITE_JPEG_QUALITY, 85)
    got = native.decode_jpeg(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    assert (got[..., 0] == got[..., 2]).all()


def _with_exif_orientation(data, orientation):
    """Splice an APP1 Exif segment with IFD0's orientation after the SOI."""
    tiff = b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
    tiff += struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0)
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_applies_it(orientation):
    data = _with_exif_orientation(_jpeg(_image(24, 40, seed=5, noise=False)), orientation)
    got = native.decode_jpeg(data)
    want = _cv2_rgb(data)
    assert got.shape == want.shape == ((40, 24, 3) if orientation >= 5 else (24, 40, 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.decode_jpeg(data, gray=True), _cv2_gray(data))


def test_progressive_is_refused_naming_its_roadmap_item():
    """The SOF2 header of a stream cv2 wrote, rewritten: to SOF10 it decodes
    as cv2 decodes it (libjpeg-turbo reads the Huffman-coded bits as
    arithmetic-coded ones, with a warning); hierarchical (SOF6, SOF14) and
    12-bit samples, which cv2 returns nothing for, raise ValueError (once
    NotImplementedError naming Queue 1 item 13c, now closed)."""
    data = _jpeg(_image(48, 64, seed=1), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    at = data.index(b"\xff\xc2")
    _assert_reads_as_cv2(data[:at + 1] + b"\xca" + data[at + 2:])
    for marker, what in ((0xC6, r"hierarchical JPEG \(SOF6\)"),
                         (0xCE, r"hierarchical JPEG \(SOF14\)")):
        _assert_cv2_refuses(data[:at + 1] + bytes([marker]) + data[at + 2:],
                            what + ": cv2 returns nothing for it")
    _assert_cv2_refuses(data[:at + 4] + b"\x0c" + data[at + 5:],
                        "12-bit samples: cv2 returns nothing for it")


# ---------------------------------------------------------------------------
# progressive JPEG (SOF2): cv2 writes libjpeg's ten-scan script (six scans
# for gray), which holds all four scan kinds: DC first and refinement, AC
# first and refinement, with end-of-band runs across blocks
# ---------------------------------------------------------------------------

def _progressive(img, *params):
    return _jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *params)


@pytest.mark.parametrize("hw,quality,sampling,restart,noise", CASES,
                         ids=[f"{h}x{w}-q{q}-{s}-rst{r}-{'noise' if n else 'smooth'}"
                              for (h, w), q, s, r, n in CASES])
def test_progressive_decode_equals_cv2(hw, quality, sampling, restart, noise):
    data = _progressive(_image(*hw, seed=hw[1] + quality, noise=noise),
                        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    assert data[data.index(b"\xff\xc2") + 1] == 0xC2
    np.testing.assert_array_equal(native.decode_jpeg(data), _cv2_rgb(data))


def _segments(data):
    """The stream's marker segments after its SOI, a scan with its
    entropy-coded data (restart markers included)."""
    out, at = [], 2
    while at < len(data):
        m = data[at + 1]
        if m == 0xD9:
            out.append(data[at:at + 2])
            at += 2
            continue
        end = at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append(data[at:end])
        at = end
    return out


def _scan(seg):
    """(Ns, Ss, Se, Ah, Al) of a scan segment, None for another segment."""
    if seg[1] != 0xDA:
        return None
    p = 5 + 2 * seg[4]
    return seg[4], seg[p], seg[p + 1], seg[p + 2] >> 4, seg[p + 2] & 15


def test_cv2_writes_the_four_scan_kinds():
    """The scan script the tests below cut: libjpeg's simple progression."""
    ycc = [_scan(s) for s in _segments(_progressive(_image(16, 16, seed=2))) if _scan(s)]
    assert ycc == [(3, 0, 0, 0, 1), (1, 1, 5, 0, 2), (1, 1, 63, 0, 1), (1, 1, 63, 0, 1),
                   (1, 6, 63, 0, 2), (1, 1, 63, 2, 1), (3, 0, 0, 1, 0), (1, 1, 63, 1, 0),
                   (1, 1, 63, 1, 0), (1, 1, 63, 1, 0)]
    gray = [_scan(s) for s in _segments(_progressive(_image(16, 16, seed=2)[..., 0]))
            if _scan(s)]
    assert gray == [(1, 0, 0, 0, 1), (1, 1, 5, 0, 2), (1, 6, 63, 0, 2), (1, 1, 63, 2, 1),
                    (1, 0, 0, 1, 0), (1, 1, 63, 1, 0)]


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (5, 3), (1, 1)])
@pytest.mark.parametrize("restart", [0, 2])
def test_progressive_gray_decodes_replicated(hw, restart):
    data = _progressive(_image(*hw, seed=7)[..., 0], cv2.IMWRITE_JPEG_QUALITY, 85,
                        cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    got = native.decode_jpeg(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_progressive_exif_orientation_as_cv2_applies_it(orientation):
    data = _with_exif_orientation(_progressive(_image(24, 40, seed=8, noise=False)),
                                  orientation)
    got = native.decode_jpeg(data)
    want = _cv2_rgb(data)
    assert got.shape == want.shape == ((40, 24, 3) if orientation >= 5 else (24, 40, 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.decode_jpeg(data, gray=True), _cv2_gray(data))


def _partial(data, keep):
    """The stream with only the scans whose index ``keep`` admits, EOI last."""
    segs = _segments(data)
    idx = [i for i, s in enumerate(segs) if _scan(s)]
    out = b"\xff\xd8" + b"".join(s for i, s in enumerate(segs)
                                   if i not in idx or keep(idx.index(i)))
    return out if out.endswith(b"\xff\xd9") else out + b"\xff\xd9"


PARTIAL = [(gray, rst, k) for gray in (False, True) for rst in (0, 2)
           for k in range(1, 6 if gray else 10)]


@pytest.mark.parametrize("gray,restart,k", PARTIAL,
                         ids=[f"{'gray' if g else 'ycc'}-rst{r}-{k}scans" for g, r, k in PARTIAL])
def test_a_partial_script_cv2_smooths_is_refused(gray, restart, k):
    """The first k scans of cv2's script: every component's DC is known and
    AC coefficients among the first nine lack bits, so libjpeg-turbo
    (SAVED_COEFS 10) smooths the blocks (once refused as Queue 1 item 13b,
    now ported): the decoder's colour and gray reads equal cv2's, and so
    does the whole script's."""
    img = _image(37, 53, seed=9)
    data = _progressive(img[..., 0] if gray else img, cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    _assert_reads_as_cv2(_partial(data, lambda i: i < k))
    _assert_reads_as_cv2(_partial(data, lambda i: True))


@pytest.mark.parametrize("gray,restart,k", PARTIAL,
                         ids=[f"{'gray' if g else 'ycc'}-rst{r}-{k}scans" for g, r, k in PARTIAL])
def test_a_partial_script_without_dc_decodes_as_cv2(gray, restart, k):
    """The first k + 1 scans of cv2's script without its DC scans: no DC is
    known, libjpeg does not smooth, and the AC bits the scans carried
    (first scans alone, or refined) decode exactly as cv2 decodes them."""
    img = _image(37, 53, seed=10)
    data = _progressive(img[..., 0] if gray else img, cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    kinds = [_scan(s) for s in _segments(data) if _scan(s)]
    cut = _partial(data, lambda i: i <= k and kinds[i][1] != 0)
    _assert_reads_as_cv2(cut)


SMOOTHED = [(hw, s, q, r) for hw in [(1, 1), (8, 8), (9, 17), (37, 53)]
            for s in ("444", "422", "420") for q in (50, 95) for r in (0, 2)]


@pytest.mark.parametrize("hw,sampling,quality,restart", SMOOTHED,
                         ids=[f"{h}x{w}-{s}-q{q}-rst{r}" for (h, w), s, q, r in SMOOTHED])
def test_every_prefix_of_cv2_script_is_smoothed_as_cv2_smooths_it(hw, sampling, quality,
                                                                  restart):
    """libjpeg-turbo's block smoothing on each prefix of cv2's ten-scan
    script: the DC-only prefixes (the DC and the first nine AC positions
    predicted from the 5x5 blocks around, change_dc), the prefixes with AC
    bits (the five low positions, each prediction clipped by its known
    bits), the edge blocks replicated on every component's own grid."""
    data = _progressive(_image(*hw, seed=hw[1] * 3 + quality, noise=False),
                        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    for k in range(1, 11):
        _assert_reads_as_cv2(_partial(data, lambda i: i < k))


@pytest.mark.parametrize("factors", [0x22, 0x12, 0x21])
@pytest.mark.parametrize("hw", [(9, 17), (24, 40), (33, 17)])
def test_smoothing_follows_the_declared_factors_of_a_gray_stream(hw, factors):
    """A gray stream's declared sampling factors shape nothing but
    smoothing: libjpeg walks iMCU rows of ``v`` block rows, counts the last
    one's rows its own way and reads the uncoded padding row's DC as 0.
    The header of cv2's gray stream rewritten from 1x1: every prefix still
    equals cv2's decode."""
    data = _progressive(_image(*hw, seed=13, noise=False)[..., 0])
    at = data.index(b"\xff\xc2")
    assert data[at + 11] == 0x11
    data = data[:at + 11] + bytes([factors]) + data[at + 12:]
    for k in range(1, 7):
        _assert_reads_as_cv2(_partial(data, lambda i: i < k))


def test_progressive_scan_parameters_are_checked_as_libjpeg_checks_them():
    """A DC band past coefficient 0, an AC band of two components, Se < Ss
    or past 63, a refinement not one bit below the last, Al over 13: cv2
    refuses each, and so does the decoder (ValueError)."""
    data = _progressive(_image(16, 24, seed=11))
    segs = _segments(data)
    first_ac = next(i for i, s in enumerate(segs) if _scan(s) and _scan(s)[1] == 1)
    dc = next(i for i, s in enumerate(segs) if _scan(s))

    def with_params(i, ss, se, a):
        seg = bytearray(segs[i])
        p = 5 + 2 * seg[4]
        seg[p:p + 3] = bytes([ss, se, a])
        return b"\xff\xd8" + b"".join(bytes(seg) if j == i else s for j, s in enumerate(segs))

    bad = [with_params(dc, 0, 5, 0x01), with_params(first_ac, 6, 5, 0x02),
           with_params(first_ac, 1, 64, 0x02), with_params(first_ac, 1, 5, 0x30),
           with_params(first_ac, 1, 5, 0x0E)]
    seg = bytearray(segs[dc])  # the three-component DC scan made an AC scan
    p = 5 + 2 * seg[4]
    seg[p:p + 3] = bytes([1, 5, 0x02])
    bad.append(b"\xff\xd8" + b"".join(bytes(seg) if j == dc else s for j, s in enumerate(segs)))
    for b in bad:
        assert cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="progressive scan parameters"):
            native.decode_jpeg(b)


def test_progressive_truncated_and_corrupt_streams_raise_or_decode(tmp_path):
    """Every prefix of a progressive 4:2:0 stream with restarts, and flipped
    bytes, either decode to an image of the header's size or raise
    ValueError (NotImplementedError where a flip makes a header the decoder
    does not take, such as sampling factors above 2): no read outside the
    stream.  A prefix that decodes ends at a
    scan's end, and equals what ``cv2.imread`` makes of the file (its
    reader ends a file that stops early with an EOI, and smooths the
    blocks of the scans that came)."""
    data = _progressive(_image(37, 53, seed=12), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        SAMPLING["420"], cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    outcomes = {"decoded": 0, "ValueError": 0, "NotImplementedError": 0}

    def attempt(b):
        try:
            img = native.decode_jpeg(b)
            assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
            outcomes["decoded"] += 1
            return img
        except ValueError:
            outcomes["ValueError"] += 1
        except NotImplementedError:
            outcomes["NotImplementedError"] += 1

    prefixes = 0
    for cut in range(len(data)):
        img = attempt(data[:cut])
        if img is not None:
            (tmp_path / "cut.jpg").write_bytes(data[:cut])
            want = cv2.cvtColor(cv2.imread(str(tmp_path / "cut.jpg")), cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(img, want)
            prefixes += 1
    assert prefixes >= 10  # one for each scan at least
    rng = np.random.default_rng(1)
    for _ in range(600):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        attempt(bytes(b))
    assert outcomes["decoded"] > prefixes and outcomes["ValueError"] > 0, outcomes
    # the stream without its EOI alone still holds every scan
    np.testing.assert_array_equal(native.decode_jpeg(data[:-2]), _cv2_rgb(data))


def test_truncated_streams_raise_value_error():
    data = _jpeg(_image(37, 53, seed=2), cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    for cut in range(0, len(data) - 2, 7):  # every 7th prefix, the EOI excluded
        with pytest.raises(ValueError):
            native.decode_jpeg(data[:cut])
    # the stream without its EOI alone still holds the whole image
    np.testing.assert_array_equal(native.decode_jpeg(data[:-2]), _cv2_rgb(data))


def test_corrupt_streams_raise_value_error_or_decode():
    """Flipped bytes never read outside the stream: each either decodes to
    an image of the header's size or raises ValueError (NotImplementedError
    where a flip makes a header the decoder does not take, such as sampling
    factors above 2)."""
    data = _jpeg(_image(37, 53, seed=4), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 SAMPLING["420"], cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    rng = np.random.default_rng(0)
    outcomes = {"decoded": 0, "ValueError": 0, "NotImplementedError": 0}
    for _ in range(600):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        try:
            img = native.decode_jpeg(bytes(b))
            assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
            outcomes["decoded"] += 1
        except ValueError:
            outcomes["ValueError"] += 1
        except NotImplementedError:
            outcomes["NotImplementedError"] += 1
    assert outcomes["ValueError"] > 0 and outcomes["decoded"] > 0
    for bad in (b"", b"\xff\xd8", b"\x00\x01junk", data[:2] + b"\xff\xc4\x00\x13" + b"\x00" * 17):
        with pytest.raises(ValueError):
            native.decode_jpeg(bad)


def test_oversized_header_is_refused_before_allocating():
    data = _jpeg(_image(16, 16, seed=6))
    at = data.index(b"\xff\xc0")
    huge = data[:at + 5] + struct.pack(">HH", 60000, 60000) + data[at + 9:]
    with pytest.raises(ValueError, match="exceeds the limit"):
        native.decode_jpeg(huge)
    with pytest.raises(ValueError, match="exceeds the limit"):
        native.decode_jpeg(data, max_pixels=255)


def test_the_committed_fixture_pair_agrees_with_cv2():
    """tests/data/serve_frame.jpg (160x120, baseline 4:2:0, written by cv2)
    and serve_frame_cv2.png (cv2's decode of it): the pair still agrees with
    cv2 here, and the port's decoder with the pair."""
    data = (DATA / "serve_frame.jpg").read_bytes()
    want = read_png(DATA / "serve_frame_cv2.png")
    assert want.shape == (120, 160, 3)
    np.testing.assert_array_equal(_cv2_rgb(data), want)
    np.testing.assert_array_equal(native.decode_jpeg(data), want)


# ---------------------------------------------------------------------------
# CMYK and YCCK (4 components), RGB-coded streams, and what stays refused
# ---------------------------------------------------------------------------

def _pil_cmyk(img, **params):
    """A CMYK JPEG as PIL writes it: Adobe marker, transform 0, the inks
    stored inverted."""
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG", **params)
    return buf.getvalue()


def _adobe_transform(data, transform):
    """The stream with its APP14 Adobe marker's transform byte set."""
    at = data.index(b"Adobe")
    return data[:at + 11] + bytes([transform]) + data[at + 12:]


CMYK = [(hw, name, t) for hw in [(1, 1), (9, 17), (37, 53)]
        for name in ("q90", "q50-progressive", "q95-420", "q75-422-progressive")
        for t in (0, 2)]
CMYK_PARAMS = {"q90": dict(quality=90), "q50-progressive": dict(quality=50, progressive=True),
               "q95-420": dict(quality=95, subsampling=2),
               "q75-422-progressive": dict(quality=75, subsampling=1, progressive=True)}


@pytest.mark.parametrize("hw,params,transform", CMYK,
                         ids=[f"{h}x{w}-{p}-{'ycck' if t else 'cmyk'}" for (h, w), p, t in CMYK])
def test_cmyk_and_ycck_read_as_cv2(hw, params, transform):
    """PIL's CMYK stream (transform 0) and the same bytes marked YCCK
    (transform 2, which libjpeg converts to CMYK first): colour and gray
    reads equal cv2's (OpenCV's own CMYK->BGR and CMYK->gray), and so does
    every prefix of a progressive script, smoothed over four components."""
    data = _adobe_transform(_pil_cmyk(_image(*hw, seed=hw[0] + transform, noise=False),
                                      **CMYK_PARAMS[params]), transform)
    assert native.jpeg_info(data)["components"] == 4
    _assert_reads_as_cv2(data)
    assert native.decode_jpeg(data).shape == hw + (3,)
    scans = [s for s in _segments(data) if _scan(s)]
    for k in range(1, len(scans)):
        _assert_reads_as_cv2(_partial(data, lambda i: i < k))


@pytest.mark.parametrize("marker", ["none", "transform-1"])
def test_four_components_without_adobes_word_read_as_cv2(marker):
    """libjpeg's guess for four components: no Adobe marker means CMYK, an
    Adobe transform other than 0 or 2 means YCCK."""
    data = _pil_cmyk(_image(19, 27, seed=18, noise=False), quality=85)
    if marker == "none":
        data = b"\xff\xd8" + b"".join(s for s in _segments(data) if s[:2] != b"\xff\xee")
        assert b"Adobe" not in data
    else:
        data = _adobe_transform(data, 1)
    _assert_reads_as_cv2(data)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_cmyk_exif_orientation_as_cv2_applies_it(orientation):
    data = _with_exif_orientation(_pil_cmyk(_image(24, 40, seed=14, noise=False)), orientation)
    _assert_reads_as_cv2(data)


def _rgb_coded(data):
    """cv2's YCbCr stream relabelled RGB: JFIF's APP0 dropped, an Adobe
    APP14 with transform 0 in its place (the samples are then read as R, G
    and B, upsampled as any component)."""
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    return b"\xff\xd8" + adobe + b"".join(s for s in _segments(data) if s[:2] != b"\xff\xe0")


RGB_CODED = [(hw, s, p) for hw in [(1, 1), (9, 17), (37, 53)] for s in SAMPLING for p in (0, 1)]


@pytest.mark.parametrize("hw,sampling,progressive", RGB_CODED,
                         ids=[f"{h}x{w}-{s}-{'progressive' if p else 'baseline'}"
                              for (h, w), s, p in RGB_CODED])
def test_rgb_coded_stream_reads_as_cv2(hw, sampling, progressive):
    """An RGB-coded stream's gray read goes through libjpeg's
    rgb_gray_convert tables; each prefix of a progressive one too."""
    data = _rgb_coded(_jpeg(_image(*hw, seed=4, noise=False), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            SAMPLING[sampling], cv2.IMWRITE_JPEG_PROGRESSIVE, progressive))
    n = len([s for s in _segments(data) if _scan(s)])
    for k in range(1, n + 1):
        _assert_reads_as_cv2(_partial(data, lambda i: i < k))


def test_pils_rgb_stream_reads_as_cv2():
    """PIL's own RGB-coded stream (``keep_rgb``: Adobe transform 0, ids
    R, G, B)."""
    for progressive in (False, True):
        buf = io.BytesIO()
        Image.fromarray(_image(37, 53, seed=15)).save(buf, "JPEG", keep_rgb=True,
                                                      progressive=progressive, quality=90)
        _assert_reads_as_cv2(buf.getvalue())


def _sof_rewritten(data, marker):
    """The baseline stream with its frame marker replaced."""
    at = data.index(b"\xff\xc0")
    return data[:at + 1] + bytes([marker]) + data[at + 2:]


def _arithmetic_progressive(gray):
    return _progressive(gray).replace(b"\xff\xc2", b"\xff\xca", 1)


def _hierarchical(gray):
    return _sof_rewritten(_jpeg(gray), 0xC5)


def _twelve_bit(gray):
    data = _jpeg(gray)
    at = data.index(b"\xff\xc0") + 4
    return data[:at] + b"\x0c" + data[at + 1:]


CODINGS_13C = {
    # coding: (a stream of it, whether cv2 5.0.0 reads it (IMREAD_COLOR,
    # IMREAD_GRAYSCALE), the decoder's message where cv2 reads neither)
    "arithmetic-sequential": (lambda g: _sof_rewritten(_jpeg(g), 0xC9), (True, True), None),
    "arithmetic-progressive": (_arithmetic_progressive, (True, True), None),
    "lossless": (enc.lossless_jpeg, (False, True), None),
    "hierarchical": (_hierarchical, (False, False), r"hierarchical JPEG \(SOF5\)"),
    "12-bit": (_twelve_bit, (False, False), r"12-bit samples"),
    "lossless-arithmetic": (lambda g: enc.lossless_jpeg(g).replace(b"\xff\xc3", b"\xff\xcb", 1),
                            (False, False), r"lossless JPEG \(SOF11\)"),
}


@pytest.mark.parametrize("coding", list(CODINGS_13C))
def test_item_13c_coding(coding):
    """Queue 1 item 13c, each coding in a stream that rewrites the headers
    of cv2's gray one, or (lossless) from the test-side encoder.  cv2 5.0.0
    reads arithmetic coding (libjpeg-turbo decodes the rewritten bits as
    arithmetic-coded, whatever they hold) and lossless through
    ``IMREAD_GRAYSCALE`` (exactly the encoder's image; its ``IMREAD_COLOR``
    returns nothing), and the decoder now reads them as cv2 does (colour
    read of lossless: ValueError).  cv2 refuses hierarchical coding, 12-bit
    samples and SOF11 through both reads; so does the decoder
    (ValueError: cv2 returns nothing for it)."""
    make, cv2_reads, message = CODINGS_13C[coding]
    gray = _image(37, 53, seed=16)[..., 0]
    data = make(gray)
    for flag, reads in zip((cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE), cv2_reads):
        assert (cv2.imdecode(np.frombuffer(data, np.uint8), flag) is not None) == reads
    if coding == "lossless":
        np.testing.assert_array_equal(_cv2_gray(data), gray)
        np.testing.assert_array_equal(native.decode_jpeg(data, gray=True), gray)
    if message is None:
        _assert_reads_as_cv2(data)
    else:
        _assert_cv2_refuses(data, message + ": cv2 returns nothing for it")


def test_an_mcu_of_more_than_ten_blocks_is_refused_as_cv2_refuses_it():
    """libjpeg's limit of ten blocks an interleaved MCU: three components
    at 2x2 (12 blocks): cv2 returns nothing, the decoder raises
    ValueError."""
    data = _jpeg(_image(16, 16, seed=17), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"])
    at = data.index(b"\xff\xc0")
    assert data[at + 11:at + 18:3] == b"\x11\x11\x11"
    bad = bytearray(data)
    bad[at + 11:at + 18:3] = b"\x22\x22\x22"
    assert cv2.imdecode(np.frombuffer(bytes(bad), np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="more than 10 blocks"):
        native.decode_jpeg(bytes(bad))


# ---------------------------------------------------------------------------
# arithmetic coding (SOF9, SOF10, DAC): streams from the test-side QM encoder
# ---------------------------------------------------------------------------

def _pixels(kind, hw, seed):
    """gray (H, W), ycc (H, W, 3) RGB coded as YCbCr, cmyk and ycck (H, W, 4)
    inks under Adobe's transform 0 and 2: smooth fields with noise."""
    rgb = _image(*hw, seed=seed, noise=False)
    if kind == "gray":
        return rgb[..., 1]
    if kind == "ycc":
        return rgb
    return np.concatenate([rgb, rgb[..., :1] // 2 + 60], -1)


def _arithmetic(kind, hw, seed=0, **kw):
    return enc.arithmetic_jpeg(_pixels(kind, hw, seed), adobe=2 if kind == "ycck" else 0, **kw)


ARITH = [(k, s, r, p, hw) for k in ("gray", "ycc", "cmyk", "ycck")
         for s in (SAMPLING if k != "gray" else ["444"]) for r in (0, 1, 2) for p in (0, 1)
         for hw in ((37, 53), (9, 17))
         if not (hw == (9, 17) and (r == 1 or k in ("cmyk", "ycck")))]


@pytest.mark.parametrize("kind,sampling,restart,progressive,hw", ARITH,
                         ids=[f"{k}-{s}-rst{r}-{'sof10' if p else 'sof9'}-{h}x{w}"
                              for k, s, r, p, (h, w) in ARITH])
def test_arithmetic_decode_equals_cv2(kind, sampling, restart, progressive, hw):
    """SOF9 and SOF10 (libjpeg's simple progression: DC first and
    refinement, AC first and refinement) at every sampling, gray and
    4-component, with restart intervals: colour and gray reads equal
    cv2's."""
    data = _arithmetic(kind, hw, seed=hw[0] + restart, quality=80, sampling=sampling,
                       progressive=bool(progressive), restart=restart)
    assert data[data.index(b"\xff\xc9" if not progressive else b"\xff\xca") + 1] in (0xC9, 0xCA)
    _assert_reads_as_cv2(data)


@pytest.mark.parametrize("kind,restart", [(k, r) for k in ("gray", "ycc", "cmyk") for r in (0, 2)])
def test_a_cut_arithmetic_script_is_smoothed_as_cv2_smooths_it(kind, restart):
    """Every prefix of an SOF10 script: libjpeg-turbo smooths the blocks
    whatever the entropy coding, as for SOF2."""
    img = _pixels(kind, (37, 53), seed=21)
    n = len(enc.YCC_SCRIPT if kind == "ycc" else enc.other_script(img.shape[2] if img.ndim == 3
                                                                   else 1))
    for k in range(1, n + 1):
        _assert_reads_as_cv2(enc.arithmetic_jpeg(img, quality=90, sampling="420",
                                                 progressive=True, restart=restart, scans=k))


DAC = {"dc-L0-U0": ({0: (0, 0), 1: (0, 0)}, {}), "dc-L3-U7": ({0: (3, 7), 1: (1, 2)}, {}),
       "dc-L2-U15": ({0: (2, 15)}, {}), "ac-K1": ({}, {0: 1, 1: 1}),
       "ac-K63": ({}, {0: 63}), "ac-K0-dc-L5-U5": ({0: (5, 5)}, {0: 0, 1: 200})}


@pytest.mark.parametrize("progressive", [0, 1], ids=["sof9", "sof10"])
@pytest.mark.parametrize("dac", DAC)
def test_dac_conditioning_reads_as_cv2(dac, progressive):
    """Conditioning other than T.81's defaults (L 0, U 1, Kx 5) in a DAC
    segment: the DC bins chosen by the last difference's category, the AC
    magnitude bins by the position against Kx."""
    dac_dc, dac_ac = DAC[dac]
    data = enc.arithmetic_jpeg(_image(37, 53, seed=22), quality=95, progressive=bool(progressive),
                               restart=3, dac_dc=dac_dc, dac_ac=dac_ac)
    assert b"\xff\xcc" in data
    _assert_reads_as_cv2(data)


def test_arithmetic_tables_past_three_and_single_component_scans_read_as_cv2():
    """Arithmetic coding's sixteen conditioning tables (a component's DC 7,
    AC 12 or 15), and a sequential stream of one scan a component."""
    img = _image(37, 53, seed=23)
    _assert_reads_as_cv2(enc.arithmetic_jpeg(img, quality=90, tables=[(7, 12), (15, 3), (15, 3)],
                                             dac_dc={7: (2, 5)}, dac_ac={12: 9}))
    for restart in (0, 3):
        _assert_reads_as_cv2(enc.arithmetic_jpeg(img, quality=90, interleaved=False,
                                                 restart=restart))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_arithmetic_exif_orientation_as_cv2_applies_it(orientation):
    for progressive in (False, True):
        data = _with_exif_orientation(enc.arithmetic_jpeg(_image(24, 40, seed=24, noise=False),
                                                          progressive=progressive), orientation)
        _assert_reads_as_cv2(data)
        assert native.decode_jpeg(data).shape == ((40, 24, 3) if orientation >= 5 else (24, 40, 3))


RANDOM = [(k, p, r, seed) for k in ("gray", "ycc", "cmyk") for p in (0, 1) for r in (0, 3)
          for seed in range(4)]


@pytest.mark.parametrize("kind,progressive,restart,seed", RANDOM,
                         ids=[f"{k}-{'sof10' if p else 'sof9'}-rst{r}-seed{s}"
                              for k, p, r, s in RANDOM])
def test_random_bits_decode_as_cv2(kind, progressive, restart, seed):
    """Seeded random bytes (each 0xFF stuffed) as every restart interval's
    entropy-coded data under SOF9 and SOF10 headers: libjpeg decodes any
    bits, and its bad-data paths (a spectral or magnitude overflow leaves
    the rest of the interval as it stands, a marker met early feeds zeros,
    coefficients past 16 bits wrap in the IDCT's lanes) are held exactly."""
    rng = np.random.default_rng(100 * seed + restart + progressive)
    data = _arithmetic(kind, (37, 53), quality=75, progressive=bool(progressive), restart=restart)
    for scan in range(data.count(b"\xff\xda")):
        data = enc.with_entropy(data, lambda i: rng.integers(
            0, 256, int(rng.integers(1, 300)), dtype=np.uint8).tobytes(), scan)
    _assert_reads_as_cv2(data)


def test_bad_dac_and_truncated_arithmetic_streams_raise_value_error():
    """A DAC with L over U, a table index past 31 or an odd length, and an
    arithmetic stream cut before its data ends: cv2 returns nothing, the
    decoder raises ValueError."""
    data = enc.arithmetic_jpeg(_image(37, 53, seed=25), quality=90, restart=2)
    for body in (bytes([0, 0x01]), bytes([32, 5]), bytes([0, 0x21, 5])):
        _assert_cv2_refuses(data[:2] + enc.segment(0xCC, body) + data[2:], "DAC")
    for cut in (len(data) - 2, len(data) - 9, len(data) // 2, 400):
        _assert_cv2_refuses(data[:cut], "arithmetic-coded data ends early|restart marker")


# ---------------------------------------------------------------------------
# lossless coding (SOF3)
# ---------------------------------------------------------------------------

def _samples(hw, precision, seed):
    """A smooth field with noise at ``precision`` bits."""
    g = _image(*hw, seed=seed, noise=False)[..., 1].astype(np.int64)
    return g >> (8 - precision)


LOSSLESS = [(pred, pt, rr) for pred in range(1, 8) for pt in (0, 1, 3) for rr in (0, 1, 4)]


@pytest.mark.parametrize("predictor,pt,restart_rows", LOSSLESS,
                         ids=[f"p{p}-pt{t}-rst{r}" for p, t, r in LOSSLESS])
def test_lossless_gray_equals_cv2_and_the_encoders_input(predictor, pt, restart_rows):
    """Predictors 1-7 with the first row, the first column and every
    restart interval's first row predicted as T.81 H.1.1 says, and point
    transforms: the gray read equals cv2's and (Pt 0) the samples coded,
    (Pt > 0) the samples with their low Pt bits cleared; the colour read of
    one component raises ValueError, as cv2 returns nothing."""
    x = _samples((37, 53), 8, seed=predictor)
    data = enc.lossless_jpeg(x, predictor=predictor, pt=pt, restart_rows=restart_rows)
    _assert_reads_as_cv2(data)
    np.testing.assert_array_equal(native.decode_jpeg(data, gray=True), (x >> pt) << pt)
    with pytest.raises(ValueError, match="colour read of a one-component lossless JPEG"):
        native.decode_jpeg(data)


@pytest.mark.parametrize("precision", range(2, 9))
def test_lossless_precisions_read_unscaled_as_cv2(precision):
    """At 2 to 7 bits cv2 returns the samples as they are (never scaled up
    to 8 bits), with Pt shifted back."""
    x = _samples((37, 53), precision, seed=precision)
    for predictor, pt in ((1, 0), (4, 0), (7, 1)):
        if pt >= precision:
            continue
        data = enc.lossless_jpeg(x, precision=precision, predictor=predictor, pt=pt,
                                 restart_rows=2)
        _assert_reads_as_cv2(data)
        np.testing.assert_array_equal(native.decode_jpeg(data, gray=True), (x >> pt) << pt)


@pytest.mark.parametrize("factors", [0x12, 0x21, 0x22])
def test_lossless_restarts_follow_libjpegs_imcu_rows(factors):
    """A gray stream's declared factors make libjpeg undifference v rows an
    iMCU row, and a restart read inside one makes only its first row a
    first row: with a restart every row and v = 2, odd rows are predicted
    from the row above, as cv2 reads them (not as T.81 would)."""
    data = enc.lossless_jpeg(_samples((9, 17), 8, seed=31), predictor=2, restart_rows=1)
    at = data.index(b"\xff\xc3")
    assert data[at + 11] == 0x11
    _assert_reads_as_cv2(data[:at + 11] + bytes([factors]) + data[at + 12:])


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "a-scan-each"])
def test_lossless_colour_reads_as_cv2(interleaved):
    """libjpeg-turbo converts no colour in lossless mode: three components
    read as RGB through IMREAD_COLOR (without JFIF's marker, or under
    Adobe's transform 0), four as CMYK (OpenCV's conversion), and every
    read that would need a conversion raises ValueError as cv2 returns
    nothing: gray of three components, YCbCr (JFIF, Adobe transform 1),
    YCCK.  Chroma at lower sampling factors is replicated."""
    planes = [_samples((37, 53), 8, seed=40 + k) for k in range(4)]
    rgb = enc.lossless_jpeg(planes[:3], predictor=6, restart_rows=3, interleaved=interleaved)
    np.testing.assert_array_equal(native.decode_jpeg(rgb), np.stack(planes[:3], -1))
    _assert_reads_as_cv2(rgb)
    jfif = rgb[:2] + enc.segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") + rgb[2:]
    adobe = [rgb[:2] + enc.segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, t])) + rgb[2:]
             for t in (0, 1)]
    for data in [jfif] + adobe:
        _assert_reads_as_cv2(data)
    cmyk = enc.lossless_jpeg(planes, predictor=5, interleaved=interleaved)
    _assert_reads_as_cv2(cmyk)
    _assert_reads_as_cv2(cmyk[:2] + enc.segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 2]))
                         + cmyk[2:])
    at = rgb.index(b"\xff\xc3")
    for f in (0x12, 0x21, 0x22, 0x31, 0x13):  # the first component's factors declared larger
        _assert_reads_as_cv2(rgb[:at + 11] + bytes([f]) + rgb[at + 12:])


def test_lossless_differences_wrap_as_libjpeg_wraps_them():
    """T.81 H.1.2.2's category 16 (32768, no extra bits) in a table of all
    17 categories, and differences that carry a sample past its precision:
    libjpeg adds modulo 2^16 and cuts the shifted sample to 8 bits, whatever
    the precision; the decoder too, and so on random bits."""
    x = _samples((9, 17), 8, seed=50)
    for diff in (100, 32768, -20, 300, -32767):
        for precision, pt, predictor in ((4, 0, 1), (8, 3, 7), (8, 0, 4)):
            _assert_reads_as_cv2(enc.lossless_jpeg(
                x >> (8 - precision), precision=precision, pt=pt, predictor=predictor,
                table=enc.ALL_CATEGORIES, extra_diffs={(0, 2, 3): diff, (0, 4, 0): -diff}))
    for seed in range(8):
        rng = np.random.default_rng(seed)
        data = enc.lossless_jpeg(x, predictor=1 + seed % 7, table=enc.ALL_CATEGORIES)
        noise = rng.integers(0, 256, 1500, np.uint8).tobytes()
        _assert_reads_as_cv2(enc.with_entropy(data, noise))


def test_lossless_streams_cv2_refuses_raise_value_error():
    """Precisions 1, 9, 12 and 16, a restart interval that is not a whole
    number of MCU rows, and scan parameters libjpeg-turbo refuses (predictor
    0 or 8, Se or Ah nonzero, Pt at the precision): cv2 returns nothing,
    the decoder raises ValueError."""
    x = _samples((9, 17), 8, seed=60)
    data = enc.lossless_jpeg(x)
    at = data.index(b"\xff\xc3")
    for precision in (1, 9, 12, 16):
        _assert_cv2_refuses(data[:at + 4] + bytes([precision]) + data[at + 5:],
                            f"lossless JPEG of {precision}-bit samples")
    rst = enc.lossless_jpeg(x, restart_rows=2)
    i = rst.index(b"\xff\xdd")
    _assert_cv2_refuses(rst[:i + 4] + struct.pack(">H", 2 * 17 - 1) + rst[i + 6:],
                        "restart interval")
    sos = data.index(b"\xff\xda") + 7
    for params in ((0, 0, 0), (8, 0, 0), (1, 1, 0), (1, 0, 0x10), (1, 0, 8)):
        _assert_cv2_refuses(data[:sos] + bytes(params) + data[sos + 3:],
                            "lossless JPEG scan parameters")
    # Pt 7 of 8 bits: libjpeg reads it
    _assert_reads_as_cv2(data[:sos] + bytes([1, 0, 7]) + data[sos + 3:])


# ---------------------------------------------------------------------------
# restart markers out of place: libjpeg's resync
# ---------------------------------------------------------------------------

def _resync_source(coding):
    """A 48x64 stream of the coding with a restart every MCU."""
    img = _image(48, 64, seed=31, noise=False)
    if coding == "baseline":
        return _jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    if coding == "progressive":
        return _progressive(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    return enc.arithmetic_jpeg(img, quality=80, restart=1,
                               progressive=coding == "arithmetic-progressive")


def _assert_file_reads_as_cv2(tmp_path, data):
    """``imread_rgb``/``imread_gray`` (the datasets) against ``cv2.imread``."""
    from mast3r_slam_tpu_torch.data import png

    path = tmp_path / "frame.jpg"
    path.write_bytes(data)
    for read, flag in ((png.imread_rgb, cv2.IMREAD_COLOR), (png.imread_gray, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imread(str(path), flag)
        if want is None:
            with pytest.raises(ValueError):
                read(path)
            continue
        if want.ndim == 3:
            want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read(path), want)


RESYNC = [(c, h) for c in ("baseline", "progressive", "arithmetic", "arithmetic-progressive")
          for h in ("next", "previous", "removed", "swapped")]


@pytest.mark.parametrize("coding,how", RESYNC, ids=[f"{c}-{h}" for c, h in RESYNC])
def test_a_wrong_restart_marker_resyncs_as_libjpeg(tmp_path, coding, how):
    """RST3 replaced by the next marker or the previous one, removed, or
    swapped with RST4, in each scan that has it: libjpeg warns and resyncs
    (``jpeg_resync_to_restart``: an RSTn of the next two intervals is left
    unread and the intervals up to it decode from zero bits, one of the two
    previous ones is passed, the one expected taken), and its entropy
    decoders go on from a marker met early (Huffman: zero bits, then the
    interval's MCUs left as they stand; arithmetic: zero bits).  Both
    reads of ``cv2.imdecode`` (the servers) and of ``cv2.imread`` (the
    datasets) give these pixels."""
    data = _resync_source(coding)
    scans = [k for k in range(len(enc.scan_spans(data)))
             if {3, 4} <= set(enc.restart_positions(data, k))]
    assert scans
    for scan in scans:
        broken = enc.break_restart(data, scan, how)
        assert cv2.imdecode(np.frombuffer(broken, np.uint8), cv2.IMREAD_COLOR) is not None
        _assert_reads_as_cv2(broken)
        _assert_file_reads_as_cv2(tmp_path, broken)


@pytest.mark.parametrize("seed", range(6))
def test_markers_met_anywhere_in_the_data_read_as_cv2(seed):
    """Seeded RSTn and EOI markers written over or into the entropy-coded
    data of every coding, or restart markers dropped: each read equals
    cv2's, or raises ValueError where cv2 returns nothing.  An EOI inside a
    progressive scan ends the input there, and libjpeg-turbo smooths the
    iMCU rows after the last one an MCU came into with data by the bits
    of the scans before it (its ``last_good_iMCU_row``)."""
    rng = np.random.default_rng(700 + seed)
    for trial in range(24):
        hw = [(48, 64), (37, 53), (17, 90)][trial % 3]
        img = _image(*hw, seed=trial, noise=False)
        restart = int(rng.integers(1, 5))
        coding = trial % 4
        if coding == 3:
            data = enc.arithmetic_jpeg(img, restart=restart, progressive=bool(rng.random() < 0.5))
        else:
            data = _jpeg(img[..., 0] if coding == 2 else img, cv2.IMWRITE_JPEG_RST_INTERVAL,
                         restart, cv2.IMWRITE_JPEG_PROGRESSIVE, coding % 2)
        spans = enc.scan_spans(data)
        out = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            start, end = spans[int(rng.integers(0, len(spans)))]
            at = int(rng.integers(start, end - 2))
            code = 0xD9 if rng.random() < 0.3 else 0xD0 + int(rng.integers(0, 8))
            if rng.random() < 0.5:
                out[at:at + 2] = bytes([0xFF, code])
            else:
                out[at:at] = bytes([0xFF, code])
        _assert_reads_as_cv2(bytes(out))


RESYNC_DIGESTS = json.loads((DATA / "resync_fixtures.json").read_text())


@pytest.mark.parametrize("name", sorted(RESYNC_DIGESTS))
def test_the_committed_resync_fixtures_agree_with_cv2(name):
    """The streams ``chip_smoke.py`` phase 21a reads on the card's host (no
    cv2 there; ``scripts/make_resync_fixtures.py`` wrote them): their
    digests are still cv2's, and the port's reads give those bytes."""
    import hashlib

    path, want = DATA / name, RESYNC_DIGESTS[name]
    digest = lambda a: hashlib.sha256(a.tobytes()).hexdigest()  # noqa: E731
    rgb = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert [digest(rgb), digest(gray), list(rgb.shape)] == \
        [want["sha256"], want["gray_sha256"], want["shape"]]
    data = path.read_bytes()
    assert digest(native.decode_jpeg(data)) == want["sha256"]
    assert digest(native.decode_jpeg(data, gray=True)) == want["gray_sha256"]

"""The port's JPEG decoder (``csrc/host/jpeg.cpp`` through
``utils/native.decode_jpeg``) against ``cv2.imdecode`` (libjpeg-turbo),
which the JAX server runs: exact pixels, since the decoder follows
libjpeg's ISLOW IDCT, its fancy upsampling and its fixed-point colour
conversion.  Progressive streams (SOF2) as cv2 writes them, with their
four scan kinds, and scripts cut from them, which libjpeg-turbo smooths
(its block smoothing, ported).  Colour read to gray as ``IMREAD_GRAYSCALE``
reads it (the Y plane, libjpeg's RGB->gray of RGB-coded streams); CMYK and
YCCK streams (PIL writes them) as OpenCV converts them.  Also: the EXIF
orientations as cv2 applies them, the refusals (arithmetic, lossless,
hierarchical and 12-bit codings raise ``NotImplementedError``, each beside
what cv2 does with it; truncated, corrupt or oversized streams
``ValueError``), and the committed fixture pair that ``chip_smoke.py``
phase 11 checks on the card's host, which has no cv2."""

import io
import pathlib
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

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
    """The colour and the gray read both equal cv2's."""
    np.testing.assert_array_equal(native.decode_jpeg(data), _cv2_rgb(data))
    np.testing.assert_array_equal(native.decode_jpeg(data, gray=True), _cv2_gray(data))


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
    """Progressive Huffman JPEG decodes now (the tests below); the codings
    that stay refused raise NotImplementedError naming their ROADMAP item:
    arithmetic coding (SOF10), hierarchical (SOF6, SOF14) and 12-bit
    samples, each found by rewriting the SOF2 header of a stream cv2
    wrote (what cv2 does with each: ``test_item_13c_coding``)."""
    data = _jpeg(_image(48, 64, seed=1), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    at = data.index(b"\xff\xc2")
    for marker, what in ((0xCA, "arithmetic-coded JPEG .SOF10."),
                         (0xC6, "hierarchical JPEG .SOF6."), (0xCE, "hierarchical JPEG .SOF14.")):
        bad = data[:at + 1] + bytes([marker]) + data[at + 2:]
        with pytest.raises(NotImplementedError, match=what + r".*Queue 1, item 13c"):
            native.decode_jpeg(bad)
    deep = data[:at + 4] + b"\x0c" + data[at + 5:]
    with pytest.raises(NotImplementedError, match=r"12-bit samples.*item 13c"):
        native.decode_jpeg(deep)


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
    ValueError (NotImplementedError where a flip names a coding the decoder
    refuses): no read outside the stream.  A prefix that decodes ends at a
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
    where a flip names a coding the decoder refuses)."""
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


# the standard luminance DC table (ITU T.81 K.3): a lossless stream's only table
_DC_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]


def _lossless_jpeg(gray):
    """A one-component lossless JPEG (SOF3, 8 bits, predictor 1, Pt 0),
    from a test-side encoder: neither cv2 nor PIL writes one."""
    H, W = gray.shape
    x = gray.astype(np.int64)
    pred = np.empty_like(x)
    pred[0, 0] = 128
    pred[0, 1:] = x[0, :-1]
    pred[1:, 0] = x[:-1, 0]
    pred[1:, 1:] = x[1:, :-1]
    codes, code, k = {}, 0, 0
    for n, count in enumerate(_DC_COUNTS, 1):
        for _ in range(count):
            codes[k] = format(code, f"0{n}b")
            code, k = code + 1, k + 1
        code <<= 1
    bits = []
    for d in (x - pred).ravel():
        size = int(abs(d)).bit_length()
        bits.append(codes[size])
        if size:
            bits.append(format(d if d > 0 else d + (1 << size) - 1, f"0{size}b"))
    b = "".join(bits)
    b += "1" * (-len(b) % 8)
    ent = bytearray()
    for i in range(0, len(b), 8):
        ent.append(int(b[i:i + 8], 2))
        if ent[-1] == 0xFF:
            ent.append(0)

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body

    return (b"\xff\xd8" + seg(0xC3, struct.pack(">BHHB", 8, H, W, 1) + b"\x01\x11\x00")
            + seg(0xC4, bytes([0x00] + _DC_COUNTS + list(range(12))))
            + seg(0xDA, b"\x01\x01\x00\x01\x00\x00") + bytes(ent) + b"\xff\xd9")


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
    # IMREAD_GRAYSCALE), the decoder's message)
    "arithmetic-sequential": (lambda g: _sof_rewritten(_jpeg(g), 0xC9), (True, True),
                              r"arithmetic-coded JPEG \(SOF9\)"),
    "arithmetic-progressive": (_arithmetic_progressive, (True, True),
                               r"arithmetic-coded JPEG \(SOF10\)"),
    "lossless": (_lossless_jpeg, (False, True), r"lossless JPEG \(SOF3\)"),
    "hierarchical": (_hierarchical, (False, False), r"hierarchical JPEG \(SOF5\)"),
    "12-bit": (_twelve_bit, (False, False), r"12-bit samples"),
}


@pytest.mark.parametrize("coding", list(CODINGS_13C))
def test_item_13c_coding(coding):
    """What is left of Queue 1 item 13c, each coding in a stream that
    rewrites the headers of cv2's gray one, or (lossless) from the encoder
    above: the decoder raises NotImplementedError naming the item, colour
    and gray reads alike.  cv2 5.0.0 reads arithmetic coding (libjpeg-turbo
    decodes the rewritten bits as arithmetic-coded, whatever they hold) and
    lossless through ``IMREAD_GRAYSCALE`` (exactly the encoder's image; its
    ``IMREAD_COLOR`` returns nothing), and refuses hierarchical coding and
    12-bit samples through both."""
    make, cv2_reads, message = CODINGS_13C[coding]
    gray = _image(37, 53, seed=16)[..., 0]
    data = make(gray)
    for flag, reads in zip((cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE), cv2_reads):
        assert (cv2.imdecode(np.frombuffer(data, np.uint8), flag) is not None) == reads
    if coding == "lossless":
        np.testing.assert_array_equal(_cv2_gray(data), gray)
    for as_gray in (False, True):
        with pytest.raises(NotImplementedError, match=message + r".*Queue 1, item 13c"):
            native.decode_jpeg(data, gray=as_gray)


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

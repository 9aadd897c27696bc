"""The port's JPEG decoder (``csrc/host/jpeg.cpp`` through
``utils/native.decode_jpeg``) against ``cv2.imdecode`` (libjpeg-turbo),
which the JAX server runs: exact pixels, since the decoder follows
libjpeg's ISLOW IDCT, its fancy upsampling and its fixed-point colour
conversion.  Also: the EXIF orientations as cv2 applies them, the refusals
(progressive raises ``NotImplementedError``; truncated, corrupt or oversized
streams ``ValueError``), and the committed fixture pair that
``chip_smoke.py`` phase 11 checks on the card's host, which has no cv2."""

import pathlib
import struct

import cv2
import numpy as np
import pytest

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


def test_progressive_is_refused_naming_its_roadmap_item():
    data = _jpeg(_image(48, 64, seed=1), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    with pytest.raises(NotImplementedError, match=r"progressive JPEG .*Queue 1, item 13"):
        native.decode_jpeg(data)


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

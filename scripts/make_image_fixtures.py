"""Write the image fixtures that ``chip_smoke.py`` phases 12, 15 and 16
decode on the card's host, which has no cv2, and the SHA-256 digests of
cv2's decode of each (``tests/data/image_fixtures.json``).  Needs cv2 and
PIL, so it runs where the tests run:

    python scripts/make_image_fixtures.py

Written under ``tests/data/``:
  image_fixtures/   small files of the codings cv2 alone does not hold
                    against a committed decode: a progressive 4:2:0 JPEG
                    with restarts, a progressive gray JPEG, 8- and 16-bit
                    RGB, RGBA, palette and Adam7 PNGs (gray+alpha, 16
                    bits), an sRGB-tagged RGBA and a gAMA-tagged 16-bit
                    RGB PNG (whose gray reads weigh linear light); an RGB-coded 4:2:0 JPEG, a CMYK JPEG (PIL's) and
                    a YCCK one (its Adobe transform set to 2); progressive
                    scripts cut short, which libjpeg-turbo smooths (4:2:0
                    and gray, with and without restarts, a CMYK one); and
                    the whole 480x640 progressive file whose first two
                    and 2 scans of a textured 480x640 progressive file, the
                    whole file beside them; arithmetic-coded JPEG from the
                    test-side QM encoder (tests/torch_jpeg_encoders.py):
                    SOF9 4:2:0, gray, with restarts, with DAC conditioning
                    and CMYK, SOF10 whole and cut after 3 scans, and
                    480x640 SOF9 and SOF10 files; lossless JPEG (SOF3)
                    at predictors 1, 4 (restarts) and 7 (Pt 2), three
                    components (which cv2 reads as RGB) and 480x640 gray;
  image_folder/     8 frames at 480x640 for the CLI run: baseline and
                    progressive JPEGs and one palette Adam7 PNG;
  serve_frames/     8 constant-gray 480x640 frames (frame k at level k + 1,
                    the stand-in model's frame id) for the served session:
                    progressive JPEGs and 16-bit PNGs in turn;
  serve_partial/    8 smooth random 480x640 fields (as chip_smoke.py's
                    smooth_images makes them, on which ViT-L with random
                    weights tracks every frame) as progressive JPEGs cut
                    after 2 to 9 scans: a client's partial frames for the
                    served ViT-L session.
The digests are of (H, W, 3) uint8 RGB, C order: ``cv2.imread`` converted
from BGR (``sha256``), and of (H, W) uint8, ``cv2.imread(...,
IMREAD_GRAYSCALE)`` (``gray_sha256``); null where cv2 returns nothing for
the read (a gray lossless file's colour read, a three-component lossless
file's gray one), which the port's reads then refuse.  The PNG variants come from the
writer of ``tests/test_torch_png_variants.py`` (cv2 writes no palette or
interlaced PNG).
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import struct
import sys

import cv2
import numpy as np
from PIL import Image

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
import torch_jpeg_encoders as enc  # noqa: E402
from test_torch_png_variants import _chunk, _with_chunks, write_png  # noqa: E402


def smooth(hw, seed):
    """A smooth random colour field with a little noise: what a camera sees
    more than noise does, and it compresses to tens of kilobytes."""
    rng = np.random.default_rng(seed)
    h, w = hw
    coarse = rng.random((h // 32 + 2, w // 32 + 2, 3))
    up = cv2.resize(coarse, (w + 64, h + 64), interpolation=cv2.INTER_CUBIC)[32:32 + h, 32:32 + w]
    y, x = np.mgrid[0:h, 0:w]
    img = 255 * up + 20 * np.sin(x / 9.0 + seed)[..., None] + rng.normal(0, 3, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def smooth_field(hw, seed):
    """A random colour field at 1/16 of the size, bilinearly upsampled."""
    low = np.random.default_rng(seed).random((hw[0] // 16, hw[1] // 16, 3))
    up = cv2.resize(low, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    return np.clip(255 * up, 0, 255).round().astype(np.uint8)


def jpeg(bgr, *params):
    ok, buf = cv2.imencode(".jpg", bgr, list(params))
    assert ok
    return buf.tobytes()


def palette_png(rgb, interlace, depth=8):
    """``rgb`` quantised to a 6x6x6 cube (216 entries) as a palette PNG."""
    idx = (rgb.astype(np.int64) * 6 // 256)
    samples = (idx[..., 0] * 36 + idx[..., 1] * 6 + idx[..., 2])[..., None]
    levels = np.arange(6) * 51
    palette = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    return write_png(samples, 3, depth, interlace, palette)


def cv2_rgb(path):
    """cv2's colour read in RGB order, None where it returns nothing."""
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def cv2_gray(path):
    return cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)


def segments(data):
    """The marker segments after the SOI, each scan with its entropy-coded
    data (restart markers included)."""
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


def first_scans(data, k):
    """The stream cut after its first k scans, an EOI appended."""
    out, scans = [], 0
    for seg in segments(data):
        if seg[1] == 0xDA:
            if scans == k:
                break
            scans += 1
        out.append(seg)
    return b"\xff\xd8" + b"".join(out) + b"\xff\xd9"


def rgb_coded(data):
    """A YCbCr stream's samples declared RGB: JFIF's APP0 dropped, an Adobe
    APP14 with transform 0 in its place."""
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    return b"\xff\xd8" + adobe + b"".join(s for s in segments(data) if s[:2] != b"\xff\xe0")


def cmyk_jpeg(rgb, transform=0, **params):
    """PIL's CMYK JPEG (Adobe transform 0, the inks stored inverted), its
    transform byte set to ``transform`` (2: YCCK)."""
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG", **params)
    data = buf.getvalue()
    at = data.index(b"Adobe")
    return data[:at + 11] + bytes([transform]) + data[at + 12:]


def main():
    files = {}
    fx = DATA / "image_fixtures"
    fx.mkdir(parents=True, exist_ok=True)
    a = smooth((120, 160), 1)
    files[fx / "progressive_420_rst.jpg"] = jpeg(
        a, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    files[fx / "progressive_gray.jpg"] = jpeg(smooth((75, 101), 2)[..., 1],
                                              cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    deep = smooth((61, 83), 3).astype(np.uint16) * 257 + np.random.default_rng(3).integers(
        0, 257, (61, 83, 3)).astype(np.uint16)
    ok, buf = cv2.imencode(".png", deep)
    files[fx / "rgb16.png"] = buf.tobytes()
    files[fx / "palette.png"] = palette_png(smooth((90, 120), 4), interlace=0)
    ga = smooth((53, 77), 5)[..., :2].astype(np.uint16) * 257
    files[fx / "adam7_gray_alpha16.png"] = write_png(ga, 4, 16, 1)
    # colour files read as gray (EuRoC's read), CMYK and YCCK, scripts cut short
    files[fx / "rgb8.png"] = write_png(smooth((61, 83), 6), 2, 8)
    rgba = np.concatenate([smooth((47, 69), 7), smooth((47, 69), 8)[..., :1]], -1)
    files[fx / "rgba8_srgb.png"] = _with_chunks(write_png(rgba, 6, 8, 1),
                                                _chunk(b"sRGB", b"\x00"))
    deep = smooth((53, 71), 14).astype(np.uint16) * 257 + np.random.default_rng(14).integers(
        0, 257, (53, 71, 3)).astype(np.uint16)
    files[fx / "rgb16_gamma.png"] = _with_chunks(write_png(deep, 2, 16),
                                                 _chunk(b"gAMA", (45455).to_bytes(4, "big")))
    files[fx / "rgb_coded_420.jpg"] = rgb_coded(jpeg(
        smooth((57, 75), 9), cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420))
    files[fx / "cmyk.jpg"] = cmyk_jpeg(smooth((64, 96), 10)[..., ::-1].copy(), quality=90)
    files[fx / "ycck_420.jpg"] = cmyk_jpeg(smooth((64, 96), 11)[..., ::-1].copy(), 2,
                                           quality=85, subsampling=2)
    files[fx / "partial_cmyk_3scans.jpg"] = first_scans(
        cmyk_jpeg(smooth((48, 72), 12)[..., ::-1].copy(), quality=80, progressive=True), 3)
    cut = smooth((120, 160), 13)
    for name, k, rst in (("partial_420_rst_3scans", 3, 2), ("partial_420_6scans", 6, 0)):
        files[fx / f"{name}.jpg"] = first_scans(jpeg(
            cut, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst), k)
    for name, k, rst in (("partial_gray_1scan", 1, 0), ("partial_gray_rst_4scans", 4, 3)):
        files[fx / f"{name}.jpg"] = first_scans(jpeg(
            cut[..., 1], cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, rst), k)

    # arithmetic coding (SOF9, SOF10, DAC) and lossless coding (SOF3)
    files[fx / "arith_420.jpg"] = enc.arithmetic_jpeg(smooth((120, 160), 15), quality=90)
    files[fx / "arith_gray.jpg"] = enc.arithmetic_jpeg(smooth((75, 101), 16)[..., 1],
                                                       quality=85)
    files[fx / "arith_420_rst.jpg"] = enc.arithmetic_jpeg(smooth((120, 160), 17), quality=90,
                                                          restart=3)
    files[fx / "arith_dac.jpg"] = enc.arithmetic_jpeg(
        smooth((57, 75), 18), quality=95, sampling="422", dac_dc={0: (2, 6), 1: (1, 3)},
        dac_ac={0: 2, 1: 9})
    arith_prog = smooth((120, 160), 19)
    files[fx / "arith_progressive_420.jpg"] = enc.arithmetic_jpeg(arith_prog, quality=90,
                                                                  progressive=True, restart=2)
    files[fx / "arith_progressive_420_3scans.jpg"] = enc.arithmetic_jpeg(
        arith_prog, quality=90, progressive=True, scans=3)
    inks = np.concatenate([smooth((64, 96), 20), smooth((64, 96), 21)[..., :1]], -1)
    files[fx / "arith_cmyk.jpg"] = enc.arithmetic_jpeg(inks, quality=90, sampling="444")
    gray = smooth((61, 83), 22)[..., 1]
    files[fx / "lossless_p1.jpg"] = enc.lossless_jpeg(gray, predictor=1)
    files[fx / "lossless_p4_rst.jpg"] = enc.lossless_jpeg(gray, predictor=4, restart_rows=5)
    files[fx / "lossless_p7_pt2.jpg"] = enc.lossless_jpeg(gray, predictor=7, pt=2)
    rgb = smooth((37, 53), 23)
    files[fx / "lossless_rgb.jpg"] = enc.lossless_jpeg([rgb[..., k] for k in range(3)],
                                                       predictor=5, restart_rows=4)
    big = smooth_field((480, 640), 24)
    files[fx / "arith_480x640.jpg"] = enc.arithmetic_jpeg(big, quality=90)
    files[fx / "arith_progressive_480x640.jpg"] = enc.arithmetic_jpeg(big, quality=90,
                                                                      progressive=True)
    files[fx / "lossless_480x640.jpg"] = enc.lossless_jpeg(big[..., 1], predictor=1)

    folder = DATA / "image_folder"
    folder.mkdir(parents=True, exist_ok=True)
    kinds = [("baseline", 90, "420"), ("progressive", 90, "420"), ("palette-adam7", 0, None),
             ("baseline", 85, "444"), ("progressive", 80, "422"), ("baseline", 95, "422"),
             ("progressive", 90, "444"), ("progressive", 75, "420")]
    sampling = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
    for i, (kind, q, s) in enumerate(kinds):
        img = smooth((480, 640), 10 + i)
        if kind == "palette-adam7":
            files[folder / f"{i:03d}.png"] = palette_png(img, interlace=1)
            continue
        files[folder / f"{i:03d}.jpg"] = jpeg(
            img, cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[s],
            cv2.IMWRITE_JPEG_PROGRESSIVE, int(kind == "progressive"),
            cv2.IMWRITE_JPEG_RST_INTERVAL, 4 * (i % 2))

    served = DATA / "serve_frames"
    served.mkdir(parents=True, exist_ok=True)
    for k in range(8):
        if k % 2 == 0:
            files[served / f"{k:03d}.jpg"] = jpeg(np.full((480, 640, 3), k + 1, np.uint8),
                                                  cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        else:
            ok, buf = cv2.imencode(".png", np.full((480, 640, 3), (k + 1) * 257, np.uint16))
            files[served / f"{k:03d}.png"] = buf.tobytes()

    # a textured 480x640 progressive 4:2:0 file and its first two scans
    whole = jpeg(smooth((480, 640), 40), cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                 cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    files[fx / "progressive_480x640.jpg"] = whole
    files[fx / "progressive_480x640_2scans.jpg"] = first_scans(whole, 2)
    # a client's partial frames: frame k cut after k + 2 of its ten scans
    partial = DATA / "serve_partial"
    partial.mkdir(parents=True, exist_ok=True)
    for k in range(8):
        files[partial / f"{k:03d}.jpg"] = first_scans(jpeg(
            smooth_field((480, 640), 40 + k), cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_RST_INTERVAL,
            4 * (k % 2)), k + 2)

    digests = {}
    for path, data in files.items():
        path.write_bytes(data)
        rgb, gray = cv2_rgb(path), cv2_gray(path)
        assert rgb is not None or gray is not None, path
        digests[str(path.relative_to(DATA))] = {
            "shape": list(rgb.shape) if rgb is not None else list(gray.shape) + [3],
            "sha256": None if rgb is None else hashlib.sha256(rgb.tobytes()).hexdigest(),
            "gray_sha256": None if gray is None else hashlib.sha256(gray.tobytes()).hexdigest()}
    (DATA / "image_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True)
                                              + "\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} files, {total} bytes; digests in tests/data/image_fixtures.json")


if __name__ == "__main__":
    main()

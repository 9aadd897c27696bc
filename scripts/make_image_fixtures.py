"""Write the image fixtures that ``chip_smoke.py`` phase 12 decodes on the
card's host, which has no cv2, and the SHA-256 digests of cv2's decode of
each (``tests/data/image_fixtures.json``).  Needs cv2, so it runs where the
tests run:

    python scripts/make_image_fixtures.py

Written under ``tests/data/``:
  image_fixtures/   small files of the codings cv2 alone does not hold
                    against a committed decode: a progressive 4:2:0 JPEG
                    with restarts, a progressive gray JPEG, a 16-bit RGB
                    PNG, a palette PNG and an Adam7 PNG (gray+alpha, 16 bits);
  image_folder/     8 frames at 480x640 for the CLI run: baseline and
                    progressive JPEGs and one palette Adam7 PNG;
  serve_frames/     8 constant-gray 480x640 frames (frame k at level k + 1,
                    the stand-in model's frame id) for the served session:
                    progressive JPEGs and 16-bit PNGs in turn.
The digests are of (H, W, 3) uint8 RGB, C order: ``cv2.imread`` converted
from BGR.  The PNG variants come from the writer of
``tests/test_torch_png_variants.py`` (cv2 writes no palette or interlaced
PNG).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import cv2
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
from test_torch_png_variants import write_png  # noqa: E402


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
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert img is not None, path
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


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

    digests = {}
    for path, data in files.items():
        path.write_bytes(data)
        rgb = cv2_rgb(path)
        digests[str(path.relative_to(DATA))] = {
            "shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (DATA / "image_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True)
                                              + "\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} files, {total} bytes; digests in tests/data/image_fixtures.json")


if __name__ == "__main__":
    main()

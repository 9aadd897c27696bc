"""Write the JPEG streams whose restart markers are out of place that
``chip_smoke.py`` phase 21a reads on the card's host, and the digests of
cv2's decode of each (``tests/data/resync_fixtures.json``, in the layout of
``tests/data/image_fixtures.json``: SHA-256 of ``cv2.imread``'s RGB and gray
reads).  Run from the repository root with cv2 installed:

    python scripts/make_resync_fixtures.py

Deterministic; ``tests/test_torch_jpeg.py`` holds the committed digests
against cv2 and the port's decoder.
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
OUT = DATA / "resync_fixtures"
sys.path[:0] = [str(ROOT / "tests")]
import torch_jpeg_encoders as enc  # noqa: E402


def smooth_field(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(x / 7.0), 128 + 100 * np.cos(y / 5.0), (3 * x + 2 * y) % 256],
                 -1)
    return np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.uint8)


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    img = smooth_field(48, 64, 31)
    sources = {
        "baseline": cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])[1].tobytes(),
        "progressive": cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
                                                  cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes(),
        "arithmetic": enc.arithmetic_jpeg(img, quality=80, restart=1),
    }
    files = {}
    for coding, data in sources.items():
        for how in ("next", "previous", "removed", "swapped"):
            files[f"{coding}_{how}.jpg"] = enc.break_restart(data, 0, how)
    # an EOI inside the third scan of a progressive stream: libjpeg-turbo
    # smooths the rows after it by the scans before
    data = sources["progressive"]
    start, end = enc.scan_spans(data)[2]
    at = (start + end) // 2
    files["progressive_eoi_in_scan.jpg"] = data[:at] + b"\xff\xd9" + data[at:]
    digests = {}
    for name, data in files.items():
        path = OUT / name
        path.write_bytes(data)
        rgb = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
        gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        digests[f"resync_fixtures/{name}"] = {
            "shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "gray_sha256": hashlib.sha256(gray.tobytes()).hexdigest()}
    (DATA / "resync_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} files, {total} bytes; digests in tests/data/resync_fixtures.json")


if __name__ == "__main__":
    main()

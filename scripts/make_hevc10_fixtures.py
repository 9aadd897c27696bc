"""Write the HEVC Main 10 video fixtures (9- and 10-bit 4:2:0) that
``chip_smoke.py`` phase 26 reads on the card's host, which has no cv2, and
the SHA-256 digests of the frames that the JAX package's ``MP4Dataset``
(``cv2.VideoCapture``, cv2 5.0.0) gives for each
(``tests/data/hevc10_fixtures.json``).  Needs cv2 and the JAX package, so
it runs where the tests run:

    python scripts/make_hevc10_fixtures.py

The streams are written here (``tests/torch_hevc_files.py``; cv2 holds no
HEVC encoder), deterministically, under ``tests/data/video_fixtures/``:
  hevc10_480x640_smooth.mp4   the content of phase 23's hevc_480x640_smooth.mp4
                              (14 frames of a smooth field panning 4 pixels a
                              frame: an IDR picture of intra DC CUs, then P
                              pictures) coded from 10-bit planes: phase 26b's
                              clip
  hevc10_1080x1920_smooth.mp4 an IDR and 2 P pictures of phase 23's 1920x1080
                              content at 10 bits: phase 26c times their decode
  hevc10_64x48_random.mp4     14 pictures of random syntax at 10 bits with
                              every tool the decoder takes (SAO offsets up to
                              31, QPs below 0, cu_qp_delta, explicit weights,
                              WPP, AMP, transform skip, 3 slices)
  hevc9_64x48_random.mov      random syntax at 9 bits, hev1 with the
                              parameter sets in band too
  hevc10_b_64x48_random.mp4   16 pictures of random B syntax at 10 bits, RASL
                              and RADL leading pictures, behind FFmpeg's ctts
                              and edit
  hevc10_48x32_bt2020.avi     random syntax at 10 bits, Annex B in AVI, full
                              range BT.2020 (non-constant luminance), chroma
                              sited top-left
The digests are of (H, W, 3) uint8 RGB, C order, as ``read_img`` returns
it, in the layout of ``scripts/make_video_fixtures.py``.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
OUT = DATA / "video_fixtures"
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]
import torch_hevc_files as hv  # noqa: E402
from make_hevc_fixtures import ALL_TOOLS, B_TOOLS  # noqa: E402
from make_video_fixtures import cv2_digests  # noqa: E402

CLI_CLIP = "hevc10_480x640_smooth.mp4"
BIG_CLIP = "hevc10_1080x1920_smooth.mp4"
NAMES = [CLI_CLIP, BIG_CLIP, "hevc10_64x48_random.mp4", "hevc9_64x48_random.mov",
         "hevc10_b_64x48_random.mp4", "hevc10_48x32_bt2020.avi"]


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    # phase 23's clips (seeds 4 and 5) at 10 bits
    s, _ = hv.smooth_stream(640, 480, 14, 4, step=4, bit_depth=10)
    hv.write_mp4(OUT / CLI_CLIP, s, 640, 480)
    s, _ = hv.smooth_stream(1920, 1080, 3, 5, step=4, bit_depth=10)
    hv.write_mp4(OUT / BIG_CLIP, s, 1920, 1080)
    tools = dict(ALL_TOOLS, bit_depth=10, pps=dict(ALL_TOOLS["pps"], init_qp=-4))
    s, _ = hv.random_stream(64, 48, 14, 60, **tools)
    hv.write_mp4(OUT / "hevc10_64x48_random.mp4", s, 64, 48)
    s, _ = hv.random_stream(64, 48, 14, 61, gop=5, inband=True, bit_depth=9, sao=True)
    hv.write_mp4(OUT / "hevc9_64x48_random.mov", s, 64, 48, fourcc=b"hev1", config_in_band=True,
                 brand=b"qt  ")
    s, o = hv.random_stream(64, 48, 16, 62, **dict(B_TOOLS, bit_depth=10))
    hv.write_mp4(OUT / "hevc10_b_64x48_random.mp4", s, 64, 48, display=o["display"])
    s, _ = hv.random_stream(48, 32, 14, 63, gop=5, bit_depth=10, sao=True,
                            vui=dict(full_range=True, prim=1, trc=14, matrix=9, chroma_loc=(2, 2)))
    hv.write_avi(OUT / "hevc10_48x32_bt2020.avi", s, 48, 32)
    digests = {f"video_fixtures/{n}": cv2_digests(OUT / n) for n in NAMES}
    (DATA / "hevc10_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum((OUT / n).stat().st_size for n in NAMES)
    print(f"{len(NAMES)} files, {total} bytes; digests in tests/data/hevc10_fixtures.json")


if __name__ == "__main__":
    main()

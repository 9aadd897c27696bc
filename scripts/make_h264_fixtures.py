"""Write the H.264 video fixtures that ``chip_smoke.py`` phases 20-22 read on
the card's host, which has no cv2, and the SHA-256 digests of the frames
that the JAX package's ``MP4Dataset`` (``cv2.VideoCapture``, cv2 5.0.0)
gives for each (``tests/data/h264_fixtures.json``).  Needs cv2 and the
JAX package, so it runs where the tests run:

    python scripts/make_h264_fixtures.py

The streams are written here (``tests/torch_h264_files.py``; cv2 holds no
H.264 encoder), deterministically, under ``tests/data/video_fixtures/``:
  h264_480x640_smooth.mp4   14 frames of a smooth field panning 4 pixels a
                            frame (an IDR picture of Intra 16x16, then P
                            pictures at the pan's vector), the clip of
                            phase 20b's CLI run
  h264_1080x1920_smooth.mp4 an IDR and 2 P pictures of the same kind at
                            1920x1080 (coded as 1088 rows, cropped): phase
                            20c times their decode
  h264_64x48_random.avi     14 pictures of random CAVLC syntax, Annex B, an
                            IDR picture every 5
  h264_100x60_slices.mov    random syntax in 3 slices a picture, 4
                            references, list modification, MMCO 1,
                            non-reference pictures, the 8x8 transform,
                            width and height cropped
  h264_72x40_full709.mp4    random syntax, full range BT.709, a VUI
                            asking for 2 pictures of reorder delay
  h264_64x48_rot90.mp4      the first random stream in an mp4 whose track
                            turns its frames 90 degrees (cv2 turns them)
  mp4v_64x48_rot270.mp4     the committed mp4v_64x48_tex.mp4 with its
                            track's display matrix set to 270 degrees
  h264_cabac_480x640_smooth.mp4
                            the pan coded with CABAC at High profile, the
                            P pictures' residual through the 8x8
                            transform: the clip of phase 21b's CLI run
  h264_cabac_1080x1920_smooth.mp4
                            the same at 1920x1080: phase 21c times it
  h264_cabac_64x48_random.mov
                            14 pictures of random CABAC syntax in 2 slices,
                            3 references, list modification
  h264_b_480x640_smooth.mp4 the pan as x264's defaults code it: I, then B B P
                            with the second B a reference (b-pyramid),
                            CABAC, the 8x8 transform, explicit weights in
                            the P pictures, implicit ones in the B pictures,
                            in decoding order behind ctts and the edit
                            FFmpeg's muxer writes: the clip of phase 22b
  h264_b_1080x1920_smooth.mp4
                            an IDR, a P and a B picture of the same kind at
                            1920x1080: phase 22c times their decode
  h264_b_64x48_random.mp4   14 pictures of random CAVLC syntax with 2 B
                            pictures between anchors, both direct modes
  h264_b_cabac_64x48_random.mov
                            random CABAC syntax, a referenced B picture in 3
                            (b-pyramid) with MMCO 1, implicit weights, 2
                            slices
  h264_b_48x32_weighted.avi random syntax with explicit weights in P and B
                            slices, Annex B in AVI (libavcodec's reorder
                            delay grown as it reads)
  h264_b_48x32_edit.mp4     random syntax behind ctts version 1 and an edit
                            that cuts the first two frames and the last one
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
import torch_h264_files as hf  # noqa: E402
from make_video_fixtures import cv2_digests  # noqa: E402

CLI_CLIP = "h264_480x640_smooth.mp4"
BIG_CLIP = "h264_1080x1920_smooth.mp4"
CABAC_CLI_CLIP = "h264_cabac_480x640_smooth.mp4"
CABAC_BIG_CLIP = "h264_cabac_1080x1920_smooth.mp4"
CABAC_RANDOM = "h264_cabac_64x48_random.mov"
B_CLI_CLIP = "h264_b_480x640_smooth.mp4"
B_BIG_CLIP = "h264_b_1080x1920_smooth.mp4"
B_NAMES = [B_CLI_CLIP, B_BIG_CLIP, "h264_b_64x48_random.mp4", "h264_b_cabac_64x48_random.mov",
           "h264_b_48x32_weighted.avi", "h264_b_48x32_edit.mp4"]
NAMES = [CLI_CLIP, BIG_CLIP, "h264_64x48_random.avi", "h264_100x60_slices.mov",
         "h264_72x40_full709.mp4", "h264_64x48_rot90.mp4", "mp4v_64x48_rot270.mp4",
         CABAC_CLI_CLIP, CABAC_BIG_CLIP, CABAC_RANDOM] + B_NAMES
# x264's defaults as far as the clip goes: 2 B pictures, b-pyramid, CABAC, 8x8
# transform, weightp (explicit, P), weightb (implicit, B)
B_CLIP = dict(cabac=True, t8=True, bframes=2, pyramid=True, p_weight=(5, 33, -2), bipred_idc=2)


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    s, _ = hf.smooth_stream(640, 480, 14, 4, step=4)
    hf.write_mp4(OUT / CLI_CLIP, s, 640, 480)
    s, _ = hf.smooth_stream(1920, 1080, 3, 5, step=4)
    hf.write_mp4(OUT / BIG_CLIP, s, 1920, 1080)
    s, _ = hf.random_stream(64, 48, 14, 20, gop=5)
    hf.write_avi_h264(OUT / "h264_64x48_random.avi", s, 64, 48)
    hf.write_mp4(OUT / "h264_64x48_rot90.mp4", s, 64, 48, matrix=(0, 1, -1, 0))
    s, _ = hf.random_stream(100, 60, 14, 21, gop=7, slices=3, max_ref=4, modify=True, mmco=True,
                            nonref=0.3)
    hf.write_mp4(OUT / "h264_100x60_slices.mov", s, 100, 60, brand=b"qt  ")
    s, _ = hf.random_stream(72, 40, 14, 22, gop=5, vui=dict(full_range=True, prim=1, trc=1,
                                                            matrix=1, reorder=2))
    hf.write_mp4(OUT / "h264_72x40_full709.mp4", s, 72, 40)
    # CABAC (High profile): the pans with the 8x8 transform, and random syntax
    s, _ = hf.smooth_stream(640, 480, 14, 4, step=4, cabac=True, t8=True)
    hf.write_mp4(OUT / CABAC_CLI_CLIP, s, 640, 480)
    s, _ = hf.smooth_stream(1920, 1080, 3, 5, step=4, cabac=True, t8=True)
    hf.write_mp4(OUT / CABAC_BIG_CLIP, s, 1920, 1080)
    s, _ = hf.random_stream(64, 48, 14, 23, gop=5, cabac=True, slices=2, max_ref=3, modify=True)
    hf.write_mp4(OUT / CABAC_RANDOM, s, 64, 48, brand=b"qt  ")
    # B pictures (x264's defaults): the pans, then random syntax
    s, o = hf.smooth_stream(640, 480, 14, 4, step=4, **B_CLIP)
    hf.write_mp4(OUT / B_CLI_CLIP, s, 640, 480, display=o["display"])
    s, o = hf.smooth_stream(1920, 1080, 3, 5, step=4, **{**B_CLIP, "bframes": 1})
    hf.write_mp4(OUT / B_BIG_CLIP, s, 1920, 1080, display=o["display"])
    s, o = hf.random_stream(64, 48, 14, 24, gop=7, bframes=2, max_ref=3)
    hf.write_mp4(OUT / "h264_b_64x48_random.mp4", s, 64, 48, display=o["display"])
    s, o = hf.random_stream(64, 48, 14, 25, gop=14, cabac=True, bframes=3, pyramid=True,
                            max_ref=4, mmco=True, bipred_idc=2, slices=2)
    hf.write_mp4(OUT / "h264_b_cabac_64x48_random.mov", s, 64, 48, display=o["display"],
                 brand=b"qt  ")
    s, o = hf.random_stream(48, 32, 14, 26, gop=14, bframes=2, max_ref=3, weighted=True,
                            bipred_idc=1)
    hf.write_avi_h264(OUT / "h264_b_48x32_weighted.avi", s, 48, 32)
    s, o = hf.random_stream(48, 32, 14, 27, gop=7, bframes=2, max_ref=3)
    hf.write_mp4(OUT / "h264_b_48x32_edit.mp4", s, 48, 32, display=o["display"], ctts_version=1,
                 edits=[(1000 * 11 // 30, 2)])
    src = (OUT / "mp4v_64x48_tex.mp4").read_bytes()
    (OUT / "mp4v_64x48_rot270.mp4").write_bytes(hf.set_matrix(src, (0, -1, 1, 0)))
    digests = {f"video_fixtures/{n}": cv2_digests(OUT / n) for n in NAMES}
    (DATA / "h264_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum((OUT / n).stat().st_size for n in NAMES)
    print(f"{len(NAMES)} files, {total} bytes; digests in tests/data/h264_fixtures.json")


if __name__ == "__main__":
    main()

"""Write the HEVC video fixtures that ``chip_smoke.py`` phases 23 and 24 read
on the card's host, which has no cv2, and the SHA-256 digests of the frames that
the JAX package's ``MP4Dataset`` (``cv2.VideoCapture``, cv2 5.0.0) gives
for each (``tests/data/hevc_fixtures.json``).  Needs cv2 and the JAX
package, so it runs where the tests run:

    python scripts/make_hevc_fixtures.py

The streams are written here (``tests/torch_hevc_files.py``; cv2 holds no
HEVC encoder), deterministically, under ``tests/data/video_fixtures/``:
  hevc_480x640_smooth.mp4   14 frames of a smooth field panning 4 pixels a
                            frame (an IDR picture of intra DC CUs, then P
                            pictures at the pan's vector; 32x32 CTBs, WPP),
                            hvc1: the clip of phase 23b's CLI run
  hevc_1080x1920_smooth.mp4 an IDR and 2 P pictures of the same kind at
                            1920x1080 (the last CTB row cut to 24 rows):
                            phase 23c times their decode
  hevc_64x48_random.mp4     14 pictures of random syntax with every tool the
                            decoder takes (WPP, AMP, transform skip, sign
                            data hiding, explicit weights, TMVP, SAO,
                            cu_qp_delta, 3 slices a picture, 3 references),
                            an IRAP picture every 7
  hevc_72x40_full709.mov    random syntax, full range BT.709, hev1 with the
                            parameter sets in band too
  hevc_64x48_rot90.mov      the first random stream in a .mov whose track
                            turns its frames 90 degrees (cv2 turns them)
  hevc_48x32_cra.avi        random syntax, Annex B in AVI, CRA sync samples,
                            an SPS asking for one picture of reorder delay
and the B-picture ones (phase 24), in decoding order as x265 orders them
(anchors 4 apart, hierarchical B pictures between), behind FFmpeg's ctts
and edit in ISO BMFF:
  hevc_b_480x640_smooth.mp4  the 480x640 pan of 14 frames with B pictures
                             bi-predicted from both sides and an open-GOP
                             CRA picture at frame 8 whose three B pictures
                             before it are RASL pictures: phase 24b's clip
  hevc_b_1080x1920_smooth.mp4  an IDR, a P and a B picture of the same kind
                             at 1920x1080: phase 24c times their decode
  hevc_b_64x48_random.mp4    18 pictures of random B syntax with every tool
                             (TMVP from either list, explicit bi-prediction
                             weights, mvd_l1_zero_flag, WPP, 2 slices),
                             RASL and RADL leading pictures
  hevc_b_64x48_rasl.mov      a stream that opens with a CRA picture whose
                             RASL pictures are never shown, hev1 in band
  hevc_b_56x40_bla.mp4       BLA pictures with RASL and RADL pictures
  hevc_b_48x32_rasl.avi      Annex B in AVI, mid-stream CRA pictures with
                             RASL pictures (no timestamps: cv2 counts the
                             packets)
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
from make_video_fixtures import cv2_digests  # noqa: E402

CLI_CLIP = "hevc_480x640_smooth.mp4"
BIG_CLIP = "hevc_1080x1920_smooth.mp4"
RANDOM = "hevc_64x48_random.mp4"
NAMES = [CLI_CLIP, BIG_CLIP, RANDOM, "hevc_72x40_full709.mov", "hevc_64x48_rot90.mov",
         "hevc_48x32_cra.avi"]
B_CLIP = "hevc_b_480x640_smooth.mp4"
B_BIG = "hevc_b_1080x1920_smooth.mp4"
B_NAMES = [B_CLIP, B_BIG, "hevc_b_64x48_random.mp4", "hevc_b_64x48_rasl.mov",
           "hevc_b_56x40_bla.mp4", "hevc_b_48x32_rasl.avi"]
# every B-slice tool the decoder takes, in one stream
B_TOOLS = dict(gop=8, bframes=3, styles=("cra-rasl", "idr-radl", "cra-radl"), tmvp=True,
               slices=2, max_ref=2, log2_ctb=4, amp=True, sao=True, p_mvd_l1_zero=0.5,
               pps=dict(wpp=True, weighted=True, weighted_bipred=True, lists_mod=True,
                        sdh=True, ts=True))
# every tool the decoder takes, in one stream
ALL_TOOLS = dict(gop=7, amp=True, tmvp=True, sao=True, slices=3, max_ref=3, log2_ctb=4,
                 pps=dict(wpp=True, ts=True, sdh=True, weighted=True, cu_qp_delta=True,
                          qg_depth=1, lists_mod=True))


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    s, _ = hv.smooth_stream(640, 480, 14, 4, step=4)
    hv.write_mp4(OUT / CLI_CLIP, s, 640, 480)
    s, _ = hv.smooth_stream(1920, 1080, 3, 5, step=4)
    hv.write_mp4(OUT / BIG_CLIP, s, 1920, 1080)
    s, _ = hv.random_stream(64, 48, 14, 30, **ALL_TOOLS)
    hv.write_mp4(OUT / RANDOM, s, 64, 48)
    hv.write_mp4(OUT / "hevc_64x48_rot90.mov", s, 64, 48, matrix=(0, 1, -1, 0), brand=b"qt  ")
    s, _ = hv.random_stream(72, 40, 14, 31, gop=5, inband=True,
                            vui=dict(full_range=True, prim=1, trc=1, matrix=1))
    hv.write_mp4(OUT / "hevc_72x40_full709.mov", s, 72, 40, fourcc=b"hev1", config_in_band=True,
                 brand=b"qt  ")
    s, _ = hv.random_stream(48, 32, 14, 32, gop=5, cra=1.0, reorder=1)
    hv.write_avi(OUT / "hevc_48x32_cra.avi", s, 48, 32)
    s, o = hv.smooth_stream(640, 480, 14, 4, step=4, gop=8, bframes=3)
    hv.write_mp4(OUT / B_CLIP, s, 640, 480, display=o["display"])
    s, o = hv.smooth_stream(1920, 1080, 3, 5, step=4, bframes=1)
    hv.write_mp4(OUT / B_BIG, s, 1920, 1080, display=o["display"])
    s, o = hv.random_stream(64, 48, 18, 40, **B_TOOLS)
    hv.write_mp4(OUT / "hevc_b_64x48_random.mp4", s, 64, 48, display=o["display"])
    s, o = hv.random_stream(64, 48, 16, 41, gop=8, bframes=3, start_cra=True, slices=1,
                            styles=("cra-rasl",), inband=True)
    hv.write_mp4(OUT / "hevc_b_64x48_rasl.mov", s, 64, 48, display=o["display"], fourcc=b"hev1",
                 config_in_band=True, brand=b"qt  ")
    s, o = hv.random_stream(56, 40, 16, 46, gop=4, bframes=3, slices=1,
                            styles=("bla-rasl", "bla-radl", "bla"))
    hv.write_mp4(OUT / "hevc_b_56x40_bla.mp4", s, 56, 40, display=o["display"])
    s, o = hv.random_stream(48, 32, 16, 43, gop=6, bframes=2, slices=1, styles=("cra-rasl",))
    hv.write_avi(OUT / "hevc_b_48x32_rasl.avi", s, 48, 32)
    NAMES.extend(B_NAMES)
    digests = {f"video_fixtures/{n}": cv2_digests(OUT / n) for n in NAMES}
    (DATA / "hevc_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum((OUT / n).stat().st_size for n in NAMES)
    print(f"{len(NAMES)} files, {total} bytes; digests in tests/data/hevc_fixtures.json")


if __name__ == "__main__":
    main()

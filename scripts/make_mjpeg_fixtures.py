"""Write the Motion-JPEG video fixtures that ``chip_smoke.py`` phase 25
reads on the card's host, which has no cv2, and the SHA-256 digests of the
frames that the JAX package's ``MP4Dataset`` (``cv2.VideoCapture``, cv2
5.0.0) gives for each (``tests/data/mjpeg_fixtures.json``).  Needs cv2
and the JAX package, so it runs where the tests run:

    python scripts/make_mjpeg_fixtures.py

Written under ``tests/data/video_fixtures/``, by real encoders:
  mjpeg_480x640_smooth.avi   OpenCV's own MJPEG writer (CAP_OPENCV_MJPEG:
                             JFIF, a DHT a frame, 4:2:0; quality 10) over phase 19's
                             content, 14 frames panning 4 pixels a frame:
                             the clip of phase 25b's CLI run
  mjpeg_1080x1920_smooth.avi the same writer, 3 frames at 1920x1080:
                             phase 25c times their decode
  mjpeg_ff_64x48_tex.avi     FFmpeg's encoder through cv2 (CAP_FFMPEG),
                             AVI fourcc MJPG
  mjpeg_ff_60x100_waves.mov  FFmpeg's, MOV sample entry ``jpeg``
  mjpeg_ff_40x72_smooth.mp4  FFmpeg's, MP4 ``mp4v`` of objectTypeIndication
                             0x6C
and libjpeg-turbo's pictures (``cv2.imencode``) in AVIs written here
(``tests/torch_mjpeg_files.py``):
  mjpeg_422_48x64_dht.avi    4:2:2, a DHT a frame
  mjpeg_422_48x64_nodht.avi  the same frames without DHT behind a UVC
                             camera's AVI1 APP0 (the default tables)
  mjpeg_420_48x64_restart.avi  4:2:0, a restart interval of 2 MCUs
  mjpeg_420_50x98_odd.avi    4:2:0 at a size that is no multiple of the MCU
  mjpeg_422_48x64_dropped.avi  4:2:2 with an empty chunk (a dropped
                             frame): cv2 counts it and shows nothing
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
import torch_mjpeg_files as mf  # noqa: E402
import torch_video_files as vf  # noqa: E402
from make_video_fixtures import cv2_digests  # noqa: E402

CLI_CLIP = "mjpeg_480x640_smooth.avi"
BIG_CLIP = "mjpeg_1080x1920_smooth.avi"
QUALITY = 10  # OpenCV's writer (its own scale: 1 writes the T.81 tables at 50, its
# default, 95, tables near 1 and two clips of 2.6 MB)
NAMES = [CLI_CLIP, BIG_CLIP, "mjpeg_ff_64x48_tex.avi", "mjpeg_ff_60x100_waves.mov",
         "mjpeg_ff_40x72_smooth.mp4", "mjpeg_422_48x64_dht.avi", "mjpeg_422_48x64_nodht.avi",
         "mjpeg_420_48x64_restart.avi", "mjpeg_420_50x98_odd.avi",
         "mjpeg_422_48x64_dropped.avi"]


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    mf.write_cv2(OUT / CLI_CLIP, vf.frames("smooth", 640, 480, 14, 4, 4), quality=QUALITY)
    mf.write_cv2(OUT / BIG_CLIP, vf.frames("smooth", 1920, 1080, 3, 5, 4), quality=QUALITY)
    mf.write_cv2(OUT / "mjpeg_ff_64x48_tex.avi", vf.frames("tex", 64, 48, 10, 6, 2), api="ffmpeg")
    mf.write_cv2(OUT / "mjpeg_ff_60x100_waves.mov", vf.frames("waves", 100, 60, 10, 7, 3), 25.0,
                 api="ffmpeg")
    mf.write_cv2(OUT / "mjpeg_ff_40x72_smooth.mp4", vf.frames("smooth", 72, 40, 10, 8, 1), 60.0,
                 api="ffmpeg")
    waves = vf.frames("waves", 64, 48, 10, 9, 2)
    pics = [mf.imencode(f, "422", 90) for f in waves]
    mf.write_avi(OUT / "mjpeg_422_48x64_dht.avi", pics, 64, 48)
    mf.write_avi(OUT / "mjpeg_422_48x64_nodht.avi",
                 [mf.with_segments(mf.strip_dht(p), [(0xE0, mf.AVI1)]) for p in pics], 64, 48)
    mf.write_avi(OUT / "mjpeg_420_48x64_restart.avi",
                 [mf.imencode(f, "420", 80, restart=2) for f in vf.frames("tex", 64, 48, 10, 10, 2)],
                 64, 48)
    mf.write_avi(OUT / "mjpeg_420_50x98_odd.avi",
                 [mf.imencode(f, "420", 85) for f in vf.frames("smooth", 98, 50, 10, 11, 3)], 98, 50,
                 fps=25)
    dropped = [mf.imencode(f, "422", 75) for f in vf.frames("smooth", 64, 48, 10, 12, 2)]
    dropped[4] = b""
    mf.write_avi(OUT / "mjpeg_422_48x64_dropped.avi", dropped, 64, 48)
    digests = {f"video_fixtures/{n}": cv2_digests(OUT / n) for n in NAMES}
    (DATA / "mjpeg_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum((OUT / n).stat().st_size for n in NAMES)
    print(f"{len(NAMES)} files, {total} bytes; digests in tests/data/mjpeg_fixtures.json")


if __name__ == "__main__":
    main()

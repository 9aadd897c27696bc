"""Write the video fixtures that ``chip_smoke.py`` phase 19 reads on the
card's host, which has no cv2, and the SHA-256 digests of the frames that
the JAX package's ``MP4Dataset`` (``cv2.VideoCapture``, cv2 5.0.0) gives
for each (``tests/data/video_fixtures.json``).  Needs cv2 and the JAX
package, so it runs where the tests run:

    python scripts/make_video_fixtures.py

Written under ``tests/data/video_fixtures/``, all MPEG-4 Part 2 from
``cv2.VideoWriter`` (libavcodec's encoder: an I-VOP every 12 frames,
P-VOPs between):
  mp4v_64x48_tex.mp4        30 frames of panning noise (coarse quantisers)
  mp4v_100x60_waves.mov     26 frames of sines, a width that is not a
                            multiple of 8 and a height not of 16
  xvid_98x50_tex.avi        30 frames of noise at 10 fps (the encoder's
                            rate scales with the fps: coarser still)
  divx_72x40_smooth.avi     30 smooth frames at 60 fps, a width that is a
                            multiple of 8 and not of 16
  mp4v_64x48_nvop.mp4       the first file with sample 5's VOP marked not
                            coded: libavcodec outputs no frame for it, so
                            cv2's frames run one sample ahead from there
                            and its last read fails
  xvid_100x60_dc.avi        written here, not by cv2 (torch_video_files.
                            dc_stream, the .mov's headers): flat blocks at
                            0 and odd levels moved by half-pel vectors
                            without rounding, where libavcodec's
                            8-wide averages are not exact ones
  xvid_100x60_random.avi    written here too (torch_video_files.
                            random_stream): an I-VOP and 8 P-VOPs of random
                            valid syntax (DQUANT, AC prediction across
                            quantisers, the three escapes, f_code 1-3,
                            stuffing, intra and not-coded macroblocks in
                            P-VOPs, coefficients that overflow the SSE2 IDCT)
  mp4v_480x640_smooth.mp4   14 smooth frames at 480x640 panning 4 pixels a
                            frame, the clip of phase 19b's CLI run
  mp4v_480x640_smooth_frame0.jpg
                            cv2's baseline JPEG (quality 95) of that clip's
                            first frame as cv2 decodes it: phase 19c times
                            its decode beside the clip's
The digests are of (H, W, 3) uint8 RGB, C order, as ``read_img`` returns
it: ``frames`` the sequential reads 0..len-1, ``seeks`` the reads at the
listed frames in that order on one dataset (each a seek, as the dataset
calls ``cap.set(CAP_PROP_POS_FRAMES, t)`` away from the next frame), and
``subsample4`` every read after ``subsample(4)``; null where cv2's read
fails (the dataset raises ``ValueError``).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
OUT = DATA / "video_fixtures"
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
import torch_video_files as vf  # noqa: E402

# name -> (fourcc, content, width, height, frames, fps, seed, pan step)
FILES = {
    "mp4v_64x48_tex.mp4": ("mp4v", "tex", 64, 48, 30, 30.0, 0, 2),
    "mp4v_100x60_waves.mov": ("mp4v", "waves", 100, 60, 26, 30.0, 1, 3),
    "xvid_98x50_tex.avi": ("XVID", "tex", 98, 50, 30, 10.0, 2, 2),
    "divx_72x40_smooth.avi": ("DIVX", "smooth", 72, 40, 30, 60.0, 3, 1),
    "mp4v_480x640_smooth.mp4": ("mp4v", "smooth", 640, 480, 14, 30.0, 4, 4),
}
NVOP = ("mp4v_64x48_nvop.mp4", "mp4v_64x48_tex.mp4", 5)  # (name, from, sample)
DC = ("xvid_100x60_dc.avi", "mp4v_100x60_waves.mov", 7)  # (name, headers from, seed)
DC_MVS = [(1, 0), (0, 1), (0, 6), (6, 0), (1, 1), (0, -6), (3, 2), (2, 5), (-1, 6), (5, 0)]
RANDOM = ("xvid_100x60_random.avi", "mp4v_100x60_waves.mov", 8, 11)  # (.., P-VOPs, seed)
CLI_CLIP = "mp4v_480x640_smooth.mp4"
CLIP_JPEG = "mp4v_480x640_smooth_frame0.jpg"
VIDEO_SUFFIXES = (".mp4", ".mov", ".avi")


def seek_order(n: int) -> list:
    """Backward and forward seeks, across GOPs, ending past the last frame."""
    return [n - 1, 2, n // 2, 0, n // 2 + 1, 13 % n, 1, 5 % n, n - 3]


def digest(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def reads(ds, order) -> list:
    out = []
    for i in order:
        try:
            out.append(digest(ds.read_img(i)))
        except ValueError:  # cv2's read failed
            out.append(None)
    return out


def cv2_digests(path) -> dict:
    """What the JAX package's MP4Dataset (cv2) gives for the file."""
    from mast3r_slam_tpu.data.dataloader import MP4Dataset

    ds = MP4Dataset(path)
    out = dict(frame_count=ds.total_frames, fps=ds.fps, frames=reads(ds, range(len(ds))))
    out["shape"] = list(MP4Dataset(path).read_img(0).shape)
    order = seek_order(len(ds))
    out["seeks"] = [[t, d] for t, d in zip(order, reads(MP4Dataset(path), order))]
    sub = MP4Dataset(path)
    sub.subsample(4)
    out["subsample4"] = reads(sub, range(len(sub)))
    return out


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    for name, (fourcc, kind, w, h, n, fps, seed, step) in FILES.items():
        vf.write_video(OUT / name, fourcc, vf.frames(kind, w, h, n, seed, step), fps)
    name, src, k = NVOP
    (OUT / name).write_bytes(vf.uncode_vop((OUT / src).read_bytes(), k))
    from mast3r_slam_tpu_torch.data.video import read_mp4

    name, src, seed = DC
    vf.write_avi(OUT / name, vf.dc_stream(read_mp4((OUT / src).read_bytes()).config, 100, 60,
                                          DC_MVS, seed), 100, 60)
    name, src, n_p, seed = RANDOM
    vf.write_avi(OUT / name, vf.random_stream(read_mp4((OUT / src).read_bytes()).config, 100,
                                              60, n_p, seed), 100, 60)
    import cv2
    from mast3r_slam_tpu.data.dataloader import MP4Dataset

    first = MP4Dataset(OUT / CLI_CLIP).read_img(0)
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(first[..., ::-1]))
    assert ok
    (OUT / CLIP_JPEG).write_bytes(buf.tobytes())
    digests = {f"video_fixtures/{p.name}": cv2_digests(p) for p in sorted(OUT.iterdir())
               if p.suffix in VIDEO_SUFFIXES}
    (DATA / "video_fixtures.json").write_text(json.dumps(digests, indent=1, sort_keys=True)
                                              + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(digests)} files, {total} bytes; digests in tests/data/video_fixtures.json")


if __name__ == "__main__":
    main()
